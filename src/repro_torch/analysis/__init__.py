"""Static analysis (`qlint`) of the port: the JAX package's ``analysis/``.

Four passes, none of which computes a step:

  lint        AST conventions over src/repro_torch (host syncs in the
              scheduler loop, literal PRNG keys and seeds in library code,
              kernel-dispatch bypasses)
  key         static enumeration of every quantization-key derivation over
              the full param trees of all configs/ families; (key, tensor)
              uniqueness + FNV hash-collision detection
  trace       the train step (f32 and quantized-state) and decode_fn /
              prefill_chunk_fn / verify_fn run once on the meta device
              under a dispatch mode that records their op graph (the
              reference's jaxpr pass, under its name ``jaxpr`` on the
              command line), walked for redundant
              quantize->dequantize->quantize round-trips, u8 wire buffers
              widened before a collective, and nondeterminism-hazard ops on
              bit-identity-guarded paths
  collective  the train step counted on meta at two depths: per-layer
              marginal collectives against
              tune.cost_model.predict_hlo_gather_counts and kernel launches
              against the engine's gather structure

Run: ``PYTHONPATH=src python -m repro_torch.analysis.qlint --all``.
Findings carry the reference's stable rule IDs;
``analysis/qlint_baseline.json`` suppresses the justified ones so the gate
is "no new findings".
"""

from .findings import RULES, Finding, load_baseline, partition_findings

__all__ = ["Finding", "RULES", "load_baseline", "partition_findings"]
