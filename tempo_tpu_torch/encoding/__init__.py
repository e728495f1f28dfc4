"""Block encodings: shared config (common.py) and the vtpu1 columnar
block (vtpu/). Port of tempo_tpu/encoding; the encoding registry and
the vrow format arrive with later slices."""
