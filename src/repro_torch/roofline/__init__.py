"""The port's roofline: hardware constants (the autotuner's cost model
reads ``HW_H100``), the op counter that stands in for the JAX package's HLO
analyzer, and the three-term report the dry run fills."""
from .analysis import (HW_H100, Hardware, RooflineReport, compute_floor,  # noqa: F401
                       roofline)
from .counter import Counter, marginal, scaled  # noqa: F401
