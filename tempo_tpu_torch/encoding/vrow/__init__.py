"""Port of tempo_tpu/encoding/vrow/__init__.py.

vrow1 — row-oriented block encoding (legacy-format parity).

Reference: tempodb/encoding/v2 — the pre-columnar format the snapshot
still ships beside vparquet: length-prefixed objects in CRC-checked
compressed pages, a downsampled ID index for binary-searched
trace-by-ID, k-way bookmark-merge compaction, and a WAL. It exists here
for the same reason it exists there: registry-proven encoding
swap-ability and reading back old data. New blocks default to vtpu1
(the columnar device-kernel encoding); vrow1 is selected via
`storage.trace.block.version: vrow1`.
"""

from tempo_tpu_torch.encoding.vrow.encoding import VERSION, Encoding  # noqa: F401
