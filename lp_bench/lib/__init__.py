"""The general harness: the specification, input generation, the drivers
of the traffic kinds, the trace reader, the work counts and the checks."""
