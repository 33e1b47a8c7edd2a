"""``cdist(Q, X, **options)`` of the table's rows.

Traffic keys: ``x_split`` (the split of both operands), ``query_rows`` (Q
is the table's first ``query_rows`` rows; null for ``cdist(X)``, the table
against itself) and ``options`` (keywords of ``cdist``, such as
``quadratic_expansion`` or ``ring``). The judge (``reference/cdist.py``)
compares every entry of this rank's rows of the result with the exact
squared distances, the widest gap over the ranks.
"""

from typing import Dict

import torch

from perfbench import generator
from perfbench.reference import cdist as ref_cdist
from perfbench.roofline import counts


class Op(generator.Op):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        ht, traffic, device = self.ht, self.traffic, self.device
        self.split = traffic["x_split"]
        self.table = generator.make_table(self.cfg, self.seed, device)
        q = traffic.get("query_rows")
        dev = generator.device_name(device)
        if q is None:
            self.query = self.table
            self.x = ht.array(self.table, split=self.split, copy=False, device=dev)
            self.y = None
        else:
            self.query = self.table[:int(q)].clone()
            self.x = ht.array(self.query, split=self.split, copy=False, device=dev)
            self.y = ht.array(self.table, split=self.split, copy=False, device=dev)
        self.rows = self.x.lshape[0]

    def _local_query(self) -> torch.Tensor:
        return generator.local_rows(self.query, self.split, self.comm)

    def program(self):
        return self.ht.spatial.cdist(self.x, self.y, **self.options)

    def stand_in(self) -> torch.Tensor:
        xq = self._local_query()
        out = torch.empty((xq.shape[0], self.table.shape[0]), dtype=torch.float32,
                          device=self.device)
        for s in range(0, xq.shape[0], 2048):
            out[s:s + 2048] = ref_cdist.distances(xq[s:s + 2048], self.table, "tf32")
        return out

    def judge(self, result) -> Dict[str, float]:
        if self.control:
            local = result
        elif tuple(result.shape) == (self.x.shape[0], self.table.shape[0]):
            local = result.larray
        else:
            return {"dist_gap": generator.worst(float("nan"), self.comm, self.device)}
        gap = ref_cdist.dist_gap(self._local_query(), self.table, lambda s, e: local[s:e])
        return {"dist_gap": generator.worst(gap, self.comm, self.device)}

    def work(self) -> Dict[str, float]:
        return counts.cdist(self.rows, self.table.shape[0], self.table.shape[1])
