"""``KMeans(n_clusters, init, max_iter, **options).fit(X)`` on the table.

Traffic keys: ``x_split`` (the split of X), ``init`` (``"rows"``: k
distinct rows drawn from the seed, handed to the program as a DNDarray and
to the reference as they are; any other string is handed to ``KMeans`` as
its ``init`` with ``random_state`` from the seed, and the judge's first pass
then starts from the program's own seeding, its fit of 0 passes) and
``options`` (further keywords of ``KMeans``, such as ``tol``). The
configuration gives ``n_clusters`` and ``max_iter``.

The judge (``reference/kmeans.py``) checks the labels of the final centers,
the first pass and the last pass from the program's own states (its fits of
1 and ``max_iter - 1`` passes on the same inputs), and the pass count.
"""

from typing import Dict, Tuple

import torch

from perfbench import generator
from perfbench.reference import kmeans as ref_kmeans
from perfbench.roofline import counts

Fit = Tuple[torch.Tensor, torch.Tensor, int]  # centers, this rank's labels, passes run


class Op(generator.Op):

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        ht, cfg, traffic, seed, device = self.ht, self.cfg, self.traffic, self.seed, self.device
        self.k, self.passes = int(cfg["n_clusters"]), int(cfg["max_iter"])
        self.split = traffic["x_split"]
        self.table = generator.make_table(cfg, seed, device)
        self.x = ht.array(self.table, split=self.split, copy=False,
                          device=generator.device_name(device))
        init = traffic.get("init", "rows")
        if init == "rows":
            pick = torch.randperm(self.table.shape[0], generator=generator.seeded(seed + 1, device),
                                  device=device)[:self.k]
            rows = self.table[pick].clone()
            self.init = ht.array(rows, split=None, copy=False,
                                 device=generator.device_name(device))
            self.start = rows
        else:
            self.init = str(init)
            self.options.setdefault("random_state", int(seed) % (1 << 31))
            self.start = None  # the program's own seeding, read by the judge
        self.rows = self.x.lshape[0]

    def _kmeans(self, passes: int):
        return self.ht.cluster.KMeans(n_clusters=self.k, init=self.init, max_iter=passes,
                                      **self.options).fit(self.x)

    def _start(self) -> torch.Tensor:
        if self.start is None:  # the program's own seeding: its fit of 0 passes
            self.start = self._kmeans(0).cluster_centers_.larray.clone()
        return self.start

    def _fit(self, passes: int) -> Fit:
        if self.control:
            centers, labels = ref_kmeans.lloyd_fit(self.table, self._start(), passes, "tf32")
            return centers, generator.local_rows(labels, self.split, self.comm), passes
        km = self._kmeans(passes)
        return km.cluster_centers_.larray, km.labels_.larray, km.n_iter_

    def program(self) -> Fit:
        return self._fit(self.passes)

    stand_in = program  # _fit computes the reference in TF32 where control

    def judge(self, result: Fit) -> Dict[str, float]:
        centers, labels, n_iter = result
        first = self._fit(1)[0]
        before_last = self._fit(self.passes - 1)[0]
        return ref_kmeans.judge_fit(generator.local_rows(self.table, self.split, self.comm),
                                    self._start(), first, before_last, centers, labels, n_iter,
                                    self.passes, reduce=generator.reducer(self.comm))

    def work(self) -> Dict[str, float]:
        return counts.kmeans_fit(self.rows, self.x.shape[1], self.k, self.passes)
