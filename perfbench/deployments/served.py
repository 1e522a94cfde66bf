"""LINEITEM as bit-packed, pinned host partitions behind a ``QueryServer``
whose device budget is a share of the table; PART resident. A request
submits a fresh ``PartitionedQuery`` and waits for its ticket; the answer
is on the host when it returns."""
from __future__ import annotations

import contextlib
import threading

from perfbench.deployments._common import host_answer, table_bytes

RESULT_TIMEOUT_S = 300.0


def partition_rows(n: int, partitions: int) -> int:
    """Rows a partition: ``n / partitions`` rounded up to a power of two
    (2^23 for SF10's LINEITEM over 8)."""
    return 1 << max(8, (-(-n // partitions) - 1).bit_length())


class Deployment:
    def __init__(self, cfg: dict, data, device):
        from repro_torch.core import compress, telemetry
        from repro_torch.core.partition import PartitionedTable
        from repro_torch.core.serve import QueryServer
        from repro_torch.core.table import Table

        dep = cfg["deployment"]
        comp = compress.CompressionConfig(**dep["compression"])
        n = len(next(iter(data.lineitem.values())))
        pt = PartitionedTable.from_arrays(
            data.lineitem, cfg=comp,
            partition_rows=partition_rows(n, dep["partitions"]),
            pack=dep["pack"], device=device)
        self.tables = {
            "lineitem": pt,
            "part": Table.from_arrays(data.part, cfg=comp, device=device)}
        self.stored_bytes = table_bytes(pt) + table_bytes(self.tables["part"])
        self._lock = threading.Lock()
        self._h2d = {"bytes": 0, "transfers": 0}
        self._scope = contextlib.ExitStack()
        self._scope.enter_context(telemetry.h2d_listener(self._moved))
        self.server = QueryServer(pt, budget_bytes=pt.nbytes() // dep["budget_divisor"],
                                  max_batch=dep["max_batch"])

    def _moved(self, nbytes, tree) -> None:
        with self._lock:
            self._h2d["bytes"] += int(nbytes)
            self._h2d["transfers"] += 1

    def warm(self, shapes: dict) -> None:
        """Every shape once, submitted together (so a shared pass runs)."""
        from repro_torch.core.partition import PartitionedQuery
        tickets = [self.server.submit(s.build(self.tables, PartitionedQuery))
                   for s in shapes.values()]
        for t in tickets:
            host_answer(self.server.result(t, timeout=RESULT_TIMEOUT_S))

    def request(self, shape):
        """``(answer, ticket stats)``."""
        from repro_torch.core.partition import PartitionedQuery
        t = self.server.submit(shape.build(self.tables, PartitionedQuery))
        res = self.server.result(t, timeout=RESULT_TIMEOUT_S)
        return host_answer(res), t.stats

    def counters(self) -> dict:
        """The server's cumulative counters and the H2D bytes moved."""
        s = self.server.stats()
        with self._lock:
            h2d = dict(self._h2d)
        return {"plan_hits": s["plan_cache"]["hits"],
                "plan_misses": s["plan_cache"]["misses"],
                "lru_hits": s["residency"]["hits"],
                "lru_misses": s["residency"]["misses"],
                "evictions": s["residency"]["evictions"],
                "passes": s["scans"]["passes"],
                "shared_queries": s["scans"]["shared_queries"],
                "solo_queries": s["scans"]["solo_queries"],
                "h2d_bytes": h2d["bytes"], "h2d_transfers": h2d["transfers"]}

    def close(self) -> None:
        if self.server is None:
            return
        self.server.close()
        self.server = None
        self._scope.close()
        self.tables = None
