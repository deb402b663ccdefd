"""The benchmark's plain reference: ``dsp.py`` (a frozen copy of the front
ends' float64 formulas) and ``model.py`` (the model, its training step and
the lower-precision controls), in plain PyTorch and numpy."""
