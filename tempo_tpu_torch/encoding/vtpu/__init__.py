"""vtpu1: the columnar block format — writer (create.py), reader
(block.py), compactor (compactor.py), page codecs (codec.py,
lightweight.py), on-disk layout (format.py), the WAL block (wal.py),
the host column cache (colcache.py) and the registry entry
(encoding.py). Port of tempo_tpu/encoding/vtpu; the device tier of the
column cache arrives with a later slice."""

VERSION = "vtpu1"
