"""Plain PyTorch reference of the EMRT configurations the benchmark runs."""
