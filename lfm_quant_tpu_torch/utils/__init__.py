"""Run-directory utilities: the metrics stream and the step timer."""
