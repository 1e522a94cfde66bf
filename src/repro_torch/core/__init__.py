"""Core library of the PyTorch port: SQL analytics on lightweight-compressed
columnar data, mirroring ``repro.core`` (DESIGN.md §2, §4).

Layers ported so far (the resident query path, the out-of-core streamed
path, and ordering on both):
  encodings   — Plain / RLE / Index / Plain+Index / RLE+Index columns & masks
  primitives  — Table-1 parallel primitives (range_intersect, idx_in_rle, ...)
  logical     — AND / OR / NOT over MaskColumns (Tables 2-5)
  arithmetic  — alignment, binary ops, comparisons, selection (§6)
  groupby     — grouping + run-aware aggregation (§7)
  join        — sort-merge join / semi-join on encoded columns (§8)
  compress    — §9 encoding-selection heuristics (host-side ingest)
  table, plan — Table container + eager query pipelines (App. D rules)
  telemetry   — spans, counters, routing records
  convert     — plain host descriptions of encoded tables (carrying state
                between the two packages)
  partition   — PartitionedTable / PartitionedQuery: zone-map pruning,
                streamed partial aggregation (out-of-core, DESIGN.md §4)
  stream      — the depth-k prefetch pipeline (copy stream + events)
  faults      — fault taxonomy + deterministic injection (DESIGN.md §15)
  order       — ORDER BY / TOP-K / LIMIT on compressed columns: bounded,
                entry and row-level ranking, the distributed top-k merge
                (DESIGN.md §10)
"""
from repro_torch.core import (  # noqa: F401
    arithmetic,
    compress,
    convert,
    faults,
    groupby,
    join,
    logical,
    order,
    partition,
    plan,
    primitives,
    stream,
    telemetry,
)
from repro_torch.core.encodings import (  # noqa: F401
    IndexColumn,
    IndexMask,
    PackedColumn,
    PlainColumn,
    PlainIndexColumn,
    PlainMask,
    RLEColumn,
    RLEIndexColumn,
    RLEIndexMask,
    RLEMask,
    decode_column,
    decode_mask,
    make_index,
    make_index_mask,
    make_plain,
    make_plain_mask,
    make_rle,
    make_rle_mask,
)
from repro_torch.core.faults import (  # noqa: F401
    DeviceOOMError,
    FaultPlan,
    TransientTransferError,
    ValidationError,
)
from repro_torch.core.order import RankedTable  # noqa: F401
from repro_torch.core.partition import (  # noqa: F401
    PartitionedQuery,
    PartitionedTable,
)
from repro_torch.core.plan import Query, col  # noqa: F401
from repro_torch.core.table import Table  # noqa: F401
