"""Runnable demos of the port on the bundled and synthetic scenes, one a
front end (`python -m progressivex_tpu_torch.examples.<name>`); each runs
on the card unless its `device` argument says "cpu"."""
