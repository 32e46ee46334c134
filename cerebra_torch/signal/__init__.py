"""Signal processing: the zero-phase band-pass of the training step."""
