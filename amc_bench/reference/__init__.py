"""The plain reference: the front end (``frontend.py``) and each
architecture's classifier (``<architecture>.py``) in plain torch and NumPy,
with the helpers they share (``common.py``), importing nothing of the
program."""
