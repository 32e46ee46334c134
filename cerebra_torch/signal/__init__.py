"""Signal processing: the zero-phase band-pass of the training step, time
windows and EEG-as-image tiling, normalisation, the ImageNet constants."""
