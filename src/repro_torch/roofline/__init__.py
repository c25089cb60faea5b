"""Hardware constants of the port's cost models (the JAX package's
``roofline/``).  Only the ``Hardware`` record and the H100 preset are
ported; a roofline read from ``torch.profiler`` is ROADMAP A12b."""
from .analysis import HW_H100, Hardware  # noqa: F401
