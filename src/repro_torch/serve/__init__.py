from .common import (ServeSetup, build_serve_setup, decode_cache_len,  # noqa: F401
                     make_prompt_batch, make_scheduler, make_serve_spec, resolve_device,
                     scheduler_batch_builder)
from .engine import (ServeEngine, greedy_sample_params, make_sample_params,  # noqa: F401
                     prefill_bucket_for, prefill_bucket_sizes)
from .kv_pool import BlockPool, ColdBlock, PoolExhausted  # noqa: F401
from .scheduler import (CompletedRequest, ContinuousScheduler, Request,  # noqa: F401
                        TokenEvent)
