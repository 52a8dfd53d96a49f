"""Run-directory utilities (the metrics stream, the step timer), run
telemetry, the metrics plane, the flight recorder, fault injection and
the numerical sanitizer (``debug.sanitized``)."""
