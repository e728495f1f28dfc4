"""vtpu1: the columnar block format — writer (create.py), reader
(block.py), compactor (compactor.py), page codecs (codec.py,
lightweight.py) and on-disk layout (format.py). Port of
tempo_tpu/encoding/vtpu; the WAL, the decoded-column cache with its
device tier, and the encoding registry arrive with later slices."""

VERSION = "vtpu1"
