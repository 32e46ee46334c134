"""Signal processing: the filters (the training step's banded zero-phase
product, the exact IIR cascade on the `sos_scan` kernel, the FFT and FIR
forms), time windows and EEG-as-image tiling and resizing, normalisation,
the stimulus-image crops of the DINO recipe, Welch PSD and band powers,
denoising (band-pass and the ICA projection) and the MNE helpers."""
