"""Standing queries: the step-partial downsampling tier (rules.py) that
block writers materialize and metrics queries read. Port of
tempo_tpu/standing/rules.py; the standing-query engine arrives with a
later slice."""
