"""Extra networks: LoRA / LyCORIS, textual inversion and hypernetworks."""


class NetworkNotFound(LookupError):
    """A LoRA, hypernetwork, ControlNet or annotator that a request names and
    no registry holds."""
