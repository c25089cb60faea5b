from .common import (ServeSetup, build_serve_setup, decode_cache_len,  # noqa: F401
                     make_prompt_batch, make_serve_spec, resolve_device)
from .engine import ServeEngine  # noqa: F401
