"""The scripts framework (``framework``) and the built-in scripts
(``builtin``, registered when it is imported)."""
