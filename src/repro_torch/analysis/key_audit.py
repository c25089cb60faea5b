"""Key audit: static (key, tensor) uniqueness over all configs/ families
(the JAX package's ``analysis/key_audit.py``).

Shift-mode rounding (paper Def. 1) draws its random shift from the
per-tensor PRNG key, so the unbiased-quantizer assumption behind QSDP's
convergence (PAPER.md Thm. 2) requires every derived key to feed exactly
one tensor.  All derivations in this repo are `fold_in` chains; two chains
collide exactly when they share a parent scope and fold the same constant.
This pass re-derives the full fold catalog — without tracing anything —
from the port's own hash function (``core.prng.stable_hash``, which is
``train.step._h``), its salts (``train.step._MASTER_SALT``,
``core.qsdp._GRAD_SALT``), the models' named group offsets and the spec
trees of every architecture family, then checks:

  QK201  one (scope, fold constant) pair claimed by two different tensors
         (e.g. a layer-scan index colliding with a group-offset constant)
  QK202  same, where both claims are FNV-1a name hashes — a hash collision
  QK203  reserved-salt overlap: the microbatch index range or a layer /
         group index range reaching a reserved salt (0x3A57E9 master,
         0x5D grad RS, 1000/2000/5000 group offsets)

Fold catalog (kept in sync with the call sites it names):
  train/step.py    step key -> fold_in(i) per microbatch; fold_in(_MASTER_SALT)
                   then fold_in(_h(name)) for the master re-quantization
  core/qsdp.py     gather keys fold stable_hash(full name) (per-tensor) /
                   stable_hash(short name) (gather_layer); grad
                   reduce-scatter folds _GRAD_SALT from the tensor key
  models/*.py      scan layers fold idx; hybrid groups fold GROUP_OFFSET+gidx
                   / TAIL_OFFSET (tail) / SAMPLE_OFFSET+gidx (decode's
                   shared block); the shared block's gather_layer folds
                   short-name hashes from the SAME group key the layer scan
                   folds its indices from; the audio encoder ENC_OFFSET
  serve/engine.py  generate() folds the decode-step index from the launch
                   key (same scope family as prefill's direct use)
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from ..core.qsdp import _GRAD_SALT as GRAD_SALT
from ..models.decode import SAMPLE_OFFSET
from ..models.transformer import ENC_OFFSET, GROUP_OFFSET, TAIL_OFFSET
from ..train.step import _MASTER_SALT as MASTER_SALT
from .findings import Finding

RESERVED = {
    MASTER_SALT: "master-requant salt (train/step.py)",
    GRAD_SALT: "grad reduce-scatter salt (core/qsdp.py)",
}


@dataclasses.dataclass(frozen=True)
class KeyUse:
    """One fold_in edge: from key scope `scope`, fold `const`, yielding the
    key for `tensor` (a param name, or a sub-scope like 'layer[3]')."""
    scope: str
    const: int
    tensor: str
    site: str        # source location family (documentation, not identity)
    from_hash: bool  # const came from a name hash (QK202 vs QK201)


def check_key_uses(uses: Iterable[KeyUse]) -> list[Finding]:
    """Collision + reserved-salt checks over a fold catalog."""
    out = []
    claimed: dict[tuple[str, int], KeyUse] = {}
    for u in uses:
        prev = claimed.get((u.scope, u.const))
        if prev is None:
            claimed[(u.scope, u.const)] = u
            continue
        if prev.tensor == u.tensor:
            continue  # same tensor re-derived identically (e.g. fwd + bwd)
        rule = "QK202" if (u.from_hash and prev.from_hash) else "QK201"
        out.append(Finding(
            rule, f"{u.scope}::0x{u.const:X}::{prev.tensor}<->{u.tensor}",
            f"key fold_in({u.const:#x}) in scope '{u.scope}' feeds both "
            f"'{prev.tensor}' ({prev.site}) and '{u.tensor}' ({u.site})"))
        # QK203: index ranges must stay clear of reserved salts
        if not (u.from_hash and prev.from_hash):
            for cand in (prev, u):
                if not cand.from_hash and cand.const in RESERVED:
                    out.append(Finding(
                        "QK203", f"{u.scope}::0x{cand.const:X}::reserved",
                        f"scope '{u.scope}' folds reserved constant "
                        f"{cand.const:#x} ({RESERVED[cand.const]})"))
    return out


def _hash_fns():
    from ..core.prng import stable_hash
    from ..train.step import _h
    return _h, stable_hash


def enumerate_key_uses(model, n_micro: int = 2,
                       serve_steps: int = 2) -> list[KeyUse]:
    """The fold catalog for one Model (train + serve schedules)."""
    from ..train.step import master_eligible
    from ..tune.cost_model import layer_groups

    _h, _stable_hash = _hash_fns()
    cfg, eng = model.cfg, model.engine
    uses: list[KeyUse] = []
    arch = cfg.name

    groups = layer_groups(eng)
    stacked = {g: (ns, stack) for g, ns, stack in groups if stack > 1}
    singles = [g for g, ns, stack in groups if stack <= 1]

    # -- step key scope: microbatch folds + master salt ---------------------
    step = f"{arch}/step"
    for i in range(n_micro):
        uses.append(KeyUse(step, i, f"micro[{i}]", "train/step.py", False))
    uses.append(KeyUse(step, MASTER_SALT, "master-requant",
                       "train/step.py", False))

    # -- master scope: _h(name) per master-eligible param -------------------
    master = f"{arch}/master"
    for name in sorted(eng.specs):
        if master_eligible(model, name):
            uses.append(KeyUse(master, _h(name), name,
                               "train/step.py qmaster", True))

    # -- loss scope (one per microbatch; identical catalog, so model once) --
    # serve prefill/decode launches reuse exactly this layout from the
    # launch key, so the same scope also covers decode_fn/prefill_fn.
    loss = f"{arch}/loss"
    for name in singles:
        uses.append(KeyUse(loss, _stable_hash(name), name,
                           "core/qsdp.py engine.gather", True))
    every = getattr(cfg, "hybrid_attn_every", 0) or 0
    if cfg.arch_type == "hybrid" and every:
        n_groups, rem = divmod(cfg.n_layers, every)
        for g in range(n_groups):
            uses.append(KeyUse(loss, GROUP_OFFSET + g, f"layer-group[{g}]",
                               "models hybrid stack", False))
            uses.append(KeyUse(loss, SAMPLE_OFFSET + g, f"sample-group[{g}]",
                               "models/decode.py hybrid sampling", False))
        if rem:
            uses.append(KeyUse(loss, TAIL_OFFSET, "layer-tail",
                               "models hybrid tail", False))
        # group scope: scan indices AND the shared block's short-name
        # hashes fold from the SAME gkey
        gscope = f"{arch}/layer-group"
        for i in range(every):
            uses.append(KeyUse(gscope, i, f"layer[{i}]",
                               "models _scan_layers", False))
        for name in sorted(eng.specs):
            if name.startswith("shared/"):
                short = name.split("/", 1)[1]
                uses.append(KeyUse(gscope, _stable_hash(short), name,
                                   "models _shared_block gather_layer", True))
    elif cfg.arch_type == "audio":
        # encoder stack scans under fold_in(key, ENC_OFFSET); the decoder
        # folds its indices straight from the loss key (see
        # Model._loss_encdec — enc/dec share short names, so a shared
        # parent scope would collide)
        uses.append(KeyUse(loss, ENC_OFFSET, "enc-stack",
                           "models _loss_encdec", False))
        escope = f"{arch}/enc-stack"
        for g, (ns, stack) in sorted(stacked.items()):
            scope, label = (escope, g) if g == "enc" else (loss, g)
            for i in range(stack):
                uses.append(KeyUse(scope, i, f"{label}[{i}]",
                                   "models _scan_layers", False))
    else:
        for g, (ns, stack) in sorted(stacked.items()):
            for i in range(stack):
                uses.append(KeyUse(loss, i, f"{g}[{i}]",
                                   "models _scan_layers", False))

    # -- layer scope: short-name hashes inside gather_layer -----------------
    for g, (ns, stack) in sorted(stacked.items()):
        lscope = f"{arch}/layer:{g}"
        for name in ns:
            short = name.split("/", 1)[1]
            uses.append(KeyUse(lscope, _stable_hash(short), name,
                               "core/qsdp.py _layer_keys", True))

    # -- tensor scope: the grad RS fold is the only child of a tensor key ---
    # (nothing else folds from it; enumerate to keep the catalog honest)
    tensor = f"{arch}/tensor"
    uses.append(KeyUse(tensor, GRAD_SALT, "grad-rs",
                       "core/qsdp.py backward", False))

    # -- serve launch scope: generate() folds decode-step indices -----------
    serve = f"{arch}/serve-launch"
    for i in range(serve_steps):
        uses.append(KeyUse(serve, i, f"decode-step[{i}]",
                           "serve/engine.py generate", False))
    return uses


def range_guards(model, n_micro: int = 2) -> list[Finding]:
    """QK203 range checks that don't show up as direct collisions in the
    (finite) catalog: index ranges growing into reserved constants."""
    out = []
    cfg = model.cfg
    arch = cfg.name
    checks = [
        ("microbatch index", n_micro, (MASTER_SALT,)),
        ("layer index", cfg.n_layers,
         (GROUP_OFFSET, TAIL_OFFSET, ENC_OFFSET, SAMPLE_OFFSET,
          MASTER_SALT)),
    ]
    every = getattr(cfg, "hybrid_attn_every", 0) or 0
    if cfg.arch_type == "hybrid" and every:
        n_groups = cfg.n_layers // every
        checks.append(("hybrid group index", GROUP_OFFSET + n_groups,
                       (TAIL_OFFSET, SAMPLE_OFFSET)))
    for what, top, salts in checks:
        for s in salts:
            if top > s:
                out.append(Finding(
                    "QK203", f"{arch}::{what.replace(' ', '-')}::0x{s:X}",
                    f"{what} range [0, {top}) of '{arch}' reaches reserved "
                    f"constant {s:#x}"))
    return out


def run(archs=None, smoke: bool = False, n_micro: int = 2) -> list[Finding]:
    """Audit every (or the given) configs/ family on a (1,1) mesh spec.
    Defaults to the FULL (non-smoke) configs — spec construction is
    metadata-only, so the real layer counts cost nothing to enumerate."""
    from .. import configs
    from ..core.qsdp import MeshSpec, QSDPConfig
    from ..models.transformer import Model

    names = list(archs) if archs else list(configs.ARCHS)
    ms = MeshSpec(axes=("data", "model"), shape=(1, 1))
    findings: list[Finding] = []
    for arch in names:
        cfg = configs.get_smoke(arch) if smoke else configs.get_config(arch)
        model = Model(cfg, ms, QSDPConfig())
        findings.extend(check_key_uses(enumerate_key_uses(model, n_micro)))
        findings.extend(range_guards(model, n_micro))
    return findings
