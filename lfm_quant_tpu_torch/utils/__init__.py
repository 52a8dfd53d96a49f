"""Run-directory utilities (the metrics stream, the step timer), run
telemetry, the metrics plane, the flight recorder and fault injection."""
