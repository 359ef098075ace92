"""Module state of the JAX package that port tests compare against.

JAX's loader keeps the external VAE it last read in a module global
(``sdwebui_tpu.loader.load.loaded_vae_file``), which JAX's infotext and its
``[vae_filename]`` pattern read; a JAX test that loads an external VAE
(``tests/test_merger.py``) leaves it set for whatever runs next in the same
process.  A port test that compares its infotexts or file names with JAX's
imports ``jax_vae_file_reset``: each of its tests starts with no external VAE
recorded, as a fresh process does, and the value comes back after it.
"""

import pytest


@pytest.fixture(autouse=True)
def jax_vae_file_reset():
    from sdwebui_tpu.loader import load as jax_load

    saved = jax_load.loaded_vae_file
    jax_load.loaded_vae_file = None
    yield
    jax_load.loaded_vae_file = saved
