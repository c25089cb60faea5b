from .synthetic import SyntheticLM, make_batch  # noqa: F401
