"""Three-term roofline of a dry-run cell (``launch.dryrun``) on H100s —
port of ``repro.roofline.analysis``.

  compute    = FLOPs            / (chips * PEAK_FLOPS_BF16)
  memory     = napkin bytes     / (chips * HBM_BW)
  collective = collective bytes / (chips * NVLINK_BW)

Sources and caveats (the constants are ``hw``'s data-sheet figures, not
measurements):

* FLOPs: ``FlopCounterMode`` over the cell's function run once at the
  global batch on the ``meta`` device (``dryrun.probe_flops``). Eager code
  runs every loop trip, so the count needs no rescale: ``hlo_flops_raw``
  equals ``hlo_flops``. It counts the matrix products of the plain
  versions the meta route runs (a causal attention's whole square, which
  the flash kernel halves).
* HBM bytes: the headline memory term is the fusion-aware napkin model
  (``napkin_bytes``, the reference's coefficients); ``hlo_bytes`` holds the
  bytes of the traced ops (each op's tensor inputs and outputs, views
  moving nothing), an upper bound that counts every elementwise pass.
* Collective bytes: the recording mesh axes' (``dryrun.RecordingAxes``)
  bytes one rank receives, times the ranks (``collective["total"]``); over
  ``chips`` links of one host's NVLink that is one rank's bytes over
  ``NVLINK_BW``. Links across hosts are not modelled.
* MODEL_FLOPS = 6·N(active)·D for train, 2·N(active)·D per generated token
  for decode: the "useful work" yardstick; its ratio to the traced FLOPs
  exposes remat and dispatch waste.
"""
from __future__ import annotations

import dataclasses
import json

from repro_torch.roofline import hw


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw measurements
    hlo_flops: float              # traced on meta, the whole depth
    hlo_flops_raw: float          # the same (eager code counts every trip)
    hlo_bytes: float              # the traced ops' bytes (upper bound)
    collective: dict
    model_flops: float
    bytes_per_device: float       # per-rank state bytes from the specs
    napkin_bytes_est: float = 0.0  # fusion-aware analytic HBM traffic
    # derived terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0         # napkin (headline; see docstring)
    t_memory_hlo_upper: float = 0.0  # traced-ops upper bound
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_fraction: float = 0.0  # MODEL_FLOPS / traced FLOPs
    roofline_fraction: float = 0.0  # MODEL_FLOPS-time / dominant-term time

    def finalize(self) -> "Roofline":
        chips = self.chips
        self.t_compute = self.hlo_flops / (chips * hw.PEAK_FLOPS_BF16)
        self.t_memory = self.napkin_bytes_est / (chips * hw.HBM_BW)
        self.t_memory_hlo_upper = self.hlo_bytes / (chips * hw.HBM_BW)
        self.t_collective = self.collective.get("total", 0.0) / (
            chips * hw.NVLINK_BW)
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_fraction = (self.model_flops / self.hlo_flops
                                if self.hlo_flops else 0.0)
        t_ideal = self.model_flops / (chips * hw.PEAK_FLOPS_BF16)
        t_dom = max(terms.values())
        self.roofline_fraction = t_ideal / t_dom if t_dom else 0.0
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def napkin_bytes(cfg, shape, *, ring_cache: bool = False,
                 param_bytes_each: float = 4.0) -> float:
    """Fusion-aware analytic HBM traffic per step (global bytes), the
    reference's model. Coefficients:

    train:   params * 32 B  (f32 read fwd + read bwd + Adam p/m/v r+w)
             + tokens*d*L*60 B  (bf16 activations fwd+bwd incl. remat ~1.5x)
             + tokens*V*8 B     (f32 logits write + bwd read)
    prefill: params * param_bytes_each + tokens*d*L*20 B + tokens*V*4 B
    decode:  params * param_bytes_each + KV/SSM state traffic + logits.
             ``ring_cache=True`` models the ring-buffer windowed cache
             (reads min(T, window) instead of T for windowed layers).
    """
    counts = cfg.param_counts()
    P_tot = counts["total"]
    B, T = shape.global_batch, shape.seq_len
    tokens = B * T
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab

    if shape.kind == "train":
        return P_tot * 32.0 + tokens * d * L * 60.0 + tokens * V * 8.0
    if shape.kind == "prefill":
        return (P_tot * param_bytes_each + tokens * d * L * 20.0
                + tokens * V * 4.0)
    # decode: one token per sequence
    cache = 0.0
    for desc in cfg.plan():
        if desc.kind == "attn":
            eff = min(T, desc.window) if (desc.window and ring_cache) else T
            cache += B * cfg.n_kv_heads * eff * cfg.head_dim * 2 * 2.0
        elif cfg.ssm_state:
            d_inner = cfg.ssm_expand * d
            H = d_inner // cfg.ssm_headdim
            cache += 2.0 * B * H * cfg.ssm_headdim * cfg.ssm_state * 4.0
    if cfg.enc_dec:
        cache += B * cfg.enc_seq * d * 2.0 * cfg.n_layers  # cross-attn reads
    return P_tot * param_bytes_each + cache + B * V * 4.0


def model_flops(cfg, shape, last_logits: bool = False) -> float:
    """Analytic useful FLOPs for the cell (per step), the reference's.

    train: 6 * N_active * tokens  (fwd 2x + bwd 4x)
    prefill: 2 * N_active * tokens (+ attention quadratic term)
    decode: 2 * N_active * batch   (one token per sequence; attention term
            counts the KV-cache dot products)
    """
    counts = cfg.param_counts()
    n_act = counts["active"] - counts.get("encoder", 0)
    n_enc = counts.get("encoder", 0)
    B, T = shape.global_batch, shape.seq_len

    # attention FLOPs (QK^T + PV): 4 * tokens * ctx * d_head * heads,
    # windowed layers use min(ctx, window)
    def attn_flops(tokens_per_seq, ctx_len):
        total = 0.0
        for desc in cfg.plan():
            if desc.kind != "attn":
                continue
            eff = min(ctx_len, desc.window) if desc.window else ctx_len
            total += 4.0 * tokens_per_seq * eff * cfg.head_dim * cfg.n_heads
        return total * B

    if shape.kind == "train":
        return (6.0 * n_act * B * T + 3.0 * attn_flops(T, T / 2)
                + 6.0 * n_enc * B * cfg.enc_seq)
    if shape.kind == "prefill":
        emb = counts.get("embedding", 0)
        if last_logits:   # unembed runs for one position per sequence
            return (2.0 * (n_act - emb / 2) * B * T + attn_flops(T, T / 2)
                    + 2.0 * n_enc * B * cfg.enc_seq + emb * B)
        return (2.0 * n_act * B * T + attn_flops(T, T / 2)
                + 2.0 * n_enc * B * cfg.enc_seq)
    # decode: one new token against a T-long cache (encoder already ran)
    return 2.0 * n_act * B * 1 + attn_flops(1, T)


def analyze(arch, shape_name, mesh_name, *, chips, traced, cfg, shape,
            bytes_per_device, ring_cache=False, param_bytes_each=4.0,
            last_logits=False) -> Roofline:
    """The cell's roofline from the dry-run's readings ``traced``:
    ``flops`` and ``bytes`` of the probe (``dryrun.probe_flops``) and the
    recording axes' ``collective``."""
    flops = float(traced["flops"])
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_flops_raw=flops,
        hlo_bytes=float(traced["bytes"]), collective=traced["collective"],
        model_flops=model_flops(cfg, shape, last_logits=last_logits),
        bytes_per_device=bytes_per_device,
        napkin_bytes_est=napkin_bytes(
            cfg, shape, ring_cache=ring_cache,
            param_bytes_each=param_bytes_each)).finalize()


def rescore(rec: dict, *, probe_flops_new: float | None = None,
            probe_bytes_new: float | None = None,
            ring_cache: bool = False) -> dict:
    """Recompute the derived terms of a saved dry-run record: fresh probe
    FLOPs and bytes (if given) + napkin memory terms."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    pf = probe_flops_new if probe_flops_new is not None else rec["hlo_flops"]
    pb = probe_bytes_new if probe_bytes_new is not None else rec["hlo_bytes"]
    roof = Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        chips=rec["chips"], hlo_flops=pf, hlo_flops_raw=pf, hlo_bytes=pb,
        collective=rec["collective"], model_flops=model_flops(cfg, shape),
        bytes_per_device=rec["bytes_per_device"],
        napkin_bytes_est=napkin_bytes(cfg, shape,
                                      ring_cache=ring_cache)).finalize()
    out = dict(rec)
    out.update(roof.to_json())
    return out


def save(results: list[Roofline], path: str):
    with open(path, "w") as f:
        json.dump([r.to_json() for r in results], f, indent=1)
