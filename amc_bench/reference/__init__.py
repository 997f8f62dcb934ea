"""The plain reference: the front end and VT-CNN2 in plain torch and NumPy,
importing nothing of the program."""
