"""LINEITEM and PART as encoded ``Table``s resident on the card. A
request builds a fresh ``Query`` (as a client would) and runs it; the
answer is on the host when it returns."""
from __future__ import annotations

from perfbench.deployments._common import host_answer, table_bytes


class Deployment:
    def __init__(self, cfg: dict, data, device):
        from repro_torch.core import compress
        from repro_torch.core.table import Table

        comp = compress.CompressionConfig(**cfg["deployment"]["compression"])
        self.tables = {
            "lineitem": Table.from_arrays(data.lineitem, cfg=comp, device=device),
            "part": Table.from_arrays(data.part, cfg=comp, device=device)}
        self.stored_bytes = (table_bytes(self.tables["lineitem"])
                             + table_bytes(self.tables["part"]))

    def warm(self, shapes: dict) -> None:
        for shape in shapes.values():
            self.request(shape)

    def request(self, shape):
        """``(answer, None)``: the shape's answer on the host."""
        from repro_torch.core.plan import Query
        return host_answer(shape.build(self.tables, Query).run()), None

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.tables = None
