"""Training: the trainer, the seed ensemble, walk-forward retraining and
the run-dir loaders the scoring entry points use."""
