"""Source lint: AST conventions over src/repro_torch (rules QS401-QS403),
the JAX package's ``analysis/source_lint.py``.

QS401  host syncs inside ``ContinuousScheduler``'s per-step loop.  The
       scheduler's contract (serve/scheduler.py) is ONE batched host sync
       per launch; any `.item()`, `.cpu()`, `.tolist()`, `.numpy()` or
       `.synchronize()` (``torch.cuda.synchronize``, a stream's or an
       event's) added to its methods is either that one deliberate sync
       (baseline it, with the justification) or a per-token/per-lane sync
       regression (fix it).  A chain such as ``x.cpu().numpy()`` is one
       sync: only its innermost call is a finding.
QS402  ``prng.PRNGKey(<int literal>)``, ``torch.manual_seed(<int literal>)``
       or ``<generator>.manual_seed(<int literal>)`` in library code.
       Seeds are caller-owned: literal keys silently correlate
       quantization noise between components that should be independent.
QS403  imports that reach past the kernels' public modules from outside
       ``kernels/``: ``kernels.ops`` (the checked wrappers, which route a
       CPU tensor to the plain version and launch the kernel for a CUDA
       one) and ``kernels.cost`` (each kernel's byte and operation
       formulas: accounting, no kernel and no dispatch, which the dry run's
       counter and ``chip_smoke.py`` read).  ``kernels.ref`` (the plain
       versions), ``kernels.build`` and the CUDA sources are private:
       calling a plain version directly would run it on a CUDA tensor in
       place of its kernel.

The lint skips ``analysis/`` (the trace harness builds programs under
synthetic keys by construction) and ``examples/`` and ``experiments/``:
the twins of the reference's ``examples/`` and ``benchmarks/`` scripts,
callers that own their seeds, which the reference's lint (rooted at
``src/repro``) does not scan either.

Pure stdlib; runs on any tree (tests point it at seeded temp dirs).
"""
from __future__ import annotations

import ast
from pathlib import Path

from .findings import Finding

HOST_SYNC_ATTRS = ("item", "cpu", "tolist", "numpy", "synchronize")
SCHEDULER_CLASS = "ContinuousScheduler"
# methods outside the admit/launch/step loop (no device work by contract)
SCHEDULER_EXEMPT = ("__init__",)
KERNEL_PKG = "kernels"
KERNEL_PUBLIC = ("ops", "cost")  # the wrappers and their work formulas
SKIP_DIRS = ("analysis/", "examples/", "experiments/")


def _attr_chain(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _host_sync_pattern(call: ast.Call) -> str:
    """Name the host-sync pattern a Call matches, or ''; a call on the
    result of another host sync (``x.cpu().numpy()``) is part of that one."""
    if not isinstance(call.func, ast.Attribute):
        return ""
    leaf = call.func.attr
    if leaf not in HOST_SYNC_ATTRS:
        return ""
    inner = call.func.value
    if isinstance(inner, ast.Call) and _host_sync_pattern(inner):
        return ""
    return leaf


def _literal_seed(call: ast.Call) -> str:
    """'PRNGKey' or 'manual_seed' for such a call whose first argument is
    an int literal, else ''."""
    leaf = _attr_chain(call.func).rsplit(".", 1)[-1]
    if leaf not in ("PRNGKey", "manual_seed"):
        return ""
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, int):
        return leaf
    return ""


def _kernel_import_violation(node: ast.AST) -> str:
    """Return the offending module path for an import that reaches past the
    kernels dispatch surface, or ''. """
    if isinstance(node, ast.ImportFrom) and node.module:
        mod = node.module
        parts = mod.split(".")
        if KERNEL_PKG in parts:
            sub = parts[parts.index(KERNEL_PKG) + 1:]
            if sub and sub[0] not in KERNEL_PUBLIC:
                return mod
            if not sub:  # from ..kernels import X — X must be public
                bad = [a.name for a in node.names
                       if a.name not in KERNEL_PUBLIC]
                if bad:
                    return f"{mod} import {','.join(bad)}"
    if isinstance(node, ast.Import):
        for a in node.names:
            parts = a.name.split(".")
            if KERNEL_PKG in parts:
                sub = parts[parts.index(KERNEL_PKG) + 1:]
                if sub and sub[0] not in KERNEL_PUBLIC:
                    return a.name
    return ""


def _lint_module(tree: ast.Module, rel: str) -> list[Finding]:
    out = []
    counts: dict[str, int] = {}

    def _site(base: str) -> str:
        # occurrence counter keeps identical patterns in one scope distinct
        n = counts.get(base, 0)
        counts[base] = n + 1
        return base if n == 0 else f"{base}#{n}"

    in_kernels = f"/{KERNEL_PKG}/" in f"/{rel}"
    for node in ast.walk(tree):
        # QS403 — anywhere outside kernels/ itself
        if not in_kernels:
            bad = _kernel_import_violation(node)
            if bad:
                out.append(Finding(
                    "QS403", _site(f"{rel}::import::{bad}"),
                    f"import reaches past kernels.{'/'.join(KERNEL_PUBLIC)} "
                    f"dispatch surface: {bad}", rel, node.lineno))
        # QS402 — module-wide
        seed = _literal_seed(node) if isinstance(node, ast.Call) else ""
        if seed:
            val = node.args[0].value
            out.append(Finding(
                "QS402", _site(f"{rel}::{seed}({val})"),
                f"literal {seed}({val}) in library code",
                rel, node.lineno))
        # QS401 — scheduler class methods only
        if isinstance(node, ast.ClassDef) and node.name == SCHEDULER_CLASS:
            for meth in node.body:
                if not isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if meth.name in SCHEDULER_EXEMPT:
                    continue
                for sub in ast.walk(meth):
                    if isinstance(sub, ast.Call):
                        pat = _host_sync_pattern(sub)
                        if pat:
                            out.append(Finding(
                                "QS401",
                                _site(f"{rel}::{SCHEDULER_CLASS}."
                                      f"{meth.name}::{pat}"),
                                f"host sync `{pat}` in scheduler loop "
                                f"method {meth.name}", rel, sub.lineno))
    return out


def lint_source(root) -> list[Finding]:
    """Lint every .py under `root` (normally src/repro_torch) but those
    under :data:`SKIP_DIRS`."""
    root = Path(root)
    out = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if rel.startswith(SKIP_DIRS):
            continue
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError as e:
            out.append(Finding("QS403", f"{rel}::parse-error",
                               f"unparseable source: {e}", rel, e.lineno or 0))
            continue
        out.extend(_lint_module(tree, rel))
    return out


def run(root=None) -> list[Finding]:
    if root is None:
        root = Path(__file__).resolve().parents[1]  # src/repro_torch
    return lint_source(root)
