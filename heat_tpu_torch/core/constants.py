"""Mathematical constants exported into the top-level namespace.

The port's own copy of ``heat_tpu/core/constants.py`` (the reference Heat's
``e``, ``Euler``, ``inf`` and aliases, ``nan`` and aliases, ``pi``).
"""

import math

__all__ = ["e", "Euler", "inf", "Inf", "Infty", "Infinity", "nan", "NaN", "pi"]

INF = float("inf")
NAN = float("nan")
PI = math.pi
E = math.e

e = E
Euler = E
inf = INF
Inf = INF
Infty = INF
Infinity = INF
nan = NAN
NaN = NAN
pi = PI
