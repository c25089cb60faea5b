"""One JAX compilation cache for the test processes, on disk under the
temporary directory.

The port's tests run the JAX package's programs as their references (train
steps, serve engines and schedulers, parameter initialisation), and every
case, file and worker builds them anew: a new jit object compiles the same
program again.  JAX's persistent cache keys an executable by its program and
its compile options, so each program compiles once in a run and is loaded
after, whichever jit object, test or worker asks for it.

Importing this module turns the cache on for the process, unless a cache
directory is set already.  ``jax.config`` is process-wide, so the JAX
package's own tests in the same process use it too: an executable loaded
from the cache is the executable that was compiled, so no result changes.
JAX decides whether to use the cache at a process's first compile; it is made
to decide again here (``compilation_cache.reset_cache``), so a process that
compiled before this import uses the cache from now on.
"""
import os
import tempfile

import jax
from jax._src import compilation_cache

if jax.config.jax_compilation_cache_dir is None:
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(tempfile.gettempdir(), "repro-tests-jax-cache"))
    # the references' programs compile in well under JAX's default second
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    compilation_cache.reset_cache()
