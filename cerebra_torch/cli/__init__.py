"""Command-line entry points (`python -m cerebra_torch.cli.<name>`): the LSTM
family and `main_dino`; retrieval analysis (`discover_channels`,
`save_channelwise_outputs`, `brain_map`); the EEG-side DINO CLIs
(`eeg_retrieval_dino`, `visualize_attention`); the teacher-feature cache
(`extract_features`) and the Gaussian-noise probe (`noise_probe`). Each
takes the JAX CLI's flags plus `--device` (cuda by default, cpu on request)."""
