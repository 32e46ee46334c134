"""Signal processing: the zero-phase band-pass of the training step, time
windows and EEG-as-image tiling, normalisation, and the stimulus-image
crops of the DINO recipe with the ImageNet constants."""
