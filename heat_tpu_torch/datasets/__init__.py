"""Bundled sample datasets: iris and diabetes as ``;``-separated CSVs.

Counterpart of ``heat_tpu/datasets``. The port keeps its own copy of the
seven files, byte for byte the JAX package's (a test compares them), so an
installed port does not depend on the JAX package's tree. They load
through the port's :func:`heat_tpu_torch.load_csv` (the native parser), as
split DNDarrays on the default device, so examples need not know where
the files are.

:func:`regenerate` rebuilds the files from scikit-learn's copies (imported
when called) into a directory the caller names; it never writes into the
package.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

_ROOT = os.path.dirname(os.path.abspath(__file__))

__all__ = ["path", "load_iris", "load_iris_split", "load_diabetes", "regenerate"]


def path(name: str) -> str:
    """Absolute path of a bundled dataset file, e.g. ``path('iris.csv')``."""
    p = os.path.join(_ROOT, name)
    if not os.path.isfile(p):
        raise FileNotFoundError(
            f"no bundled dataset {name!r}; pick one of: "
            + ", ".join(sorted(f for f in os.listdir(_ROOT) if f.endswith(".csv"))))
    return p


def _load(name: str, split: Optional[int], device, comm):
    from ..core import io

    return io.load_csv(path(name), sep=";", split=split, device=device, comm=comm)


def load_iris(split: Optional[int] = 0, device=None, comm=None):
    """Iris features (150, 4) float32 and labels (150,) int64 as DNDarrays."""
    from ..core import types

    X = _load("iris.csv", split, device, comm)
    y = _load("iris_labels.csv", split, device, comm)
    return X, y.squeeze(1).astype(types.int64)


def load_iris_split(split: Optional[int] = 0, device=None, comm=None) -> Tuple:
    """The bundled stratified 70/30 train/test split of iris
    (X_train, X_test, y_train, y_test)."""
    from ..core import types

    Xtr = _load("iris_X_train.csv", split, device, comm)
    Xte = _load("iris_X_test.csv", split, device, comm)
    ytr = _load("iris_y_train.csv", split, device, comm)
    yte = _load("iris_y_test.csv", split, device, comm)
    return Xtr, Xte, ytr.squeeze(1).astype(types.int64), yte.squeeze(1).astype(types.int64)


def load_diabetes(split: Optional[int] = 0, device=None, comm=None):
    """Diabetes features (442, 10) and target (442,) as DNDarrays."""
    D = _load("diabetes.csv", split, device, comm)
    return D[:, :10], D[:, 10]


def regenerate(directory: str) -> None:
    """Write every bundled CSV, rebuilt from scikit-learn's dataset copies,
    into ``directory`` (created if missing; never the package's own), with
    the JAX package's formats and its fixed train/test split
    (``random_state=0``, stratified)."""
    if not directory:
        raise ValueError("regenerate needs a directory to write to")
    if os.path.abspath(directory) == _ROOT:
        raise ValueError("regenerate writes to a directory the caller names, not the package")
    import numpy as np
    from sklearn import datasets as skd
    from sklearn.model_selection import train_test_split

    os.makedirs(directory, exist_ok=True)

    def wcsv(name, arr, fmt):
        np.savetxt(os.path.join(directory, name), arr, delimiter=";", fmt=fmt)

    iris = skd.load_iris()
    X, y = iris.data, iris.target
    wcsv("iris.csv", X, "%.1f")
    wcsv("iris_labels.csv", y.reshape(-1, 1), "%d")
    Xtr, Xte, ytr, yte = train_test_split(X, y, test_size=0.3, random_state=0, stratify=y)
    wcsv("iris_X_train.csv", Xtr, "%.1f")
    wcsv("iris_X_test.csv", Xte, "%.1f")
    wcsv("iris_y_train.csv", ytr.reshape(-1, 1), "%d")
    wcsv("iris_y_test.csv", yte.reshape(-1, 1), "%d")

    dia = skd.load_diabetes()
    D = np.concatenate([dia.data, dia.target.reshape(-1, 1)], axis=1)
    wcsv("diabetes.csv", D, "%.18e")
