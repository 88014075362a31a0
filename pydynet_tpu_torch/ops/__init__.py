"""Kernels and their plain versions. Nothing here builds or imports a
compiler at import time: ``_build.load()`` runs at the first launch."""
