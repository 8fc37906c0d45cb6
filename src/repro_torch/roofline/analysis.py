"""Roofline terms and model FLOPs (counterpart of
``repro/roofline/analysis.py``), with the peaks of one NVIDIA H100 SXM
from its data sheet (dense rates, no sparsity, at the 700 W power limit):

  compute term    = FLOPs / peak
  memory term     = bytes / HBM rate
  collective term = collective bytes / NVLink rate

``count_params`` and ``model_flops`` are the reference's arithmetic:
6 N_active D FLOPs for a train step of D tokens, 2 N_active D for a
forward.

The reference's ``collective_bytes_from_hlo`` reads XLA's optimized HLO
text; its counterpart here reads the port's own trace: ``TraceCounter``,
a ``TorchDispatchMode`` that sees each rank's local ops under DTensor
(it lets DTensor run first and counts the ops DTensor runs on the local
shards, so its counts are one device's, not the global program's as
``FlopCounterMode`` around DTensor code gives).  It sums, per device:

  * FLOPs of the local ops (``torch.utils.flop_counter``'s formulas);
  * bytes: every local op's input and output bytes (views and empty
    allocations excepted), an unfused count, an upper bound of what a
    fused program moves;
  * collective bytes: the result bytes of each ``c10d_functional``
    collective by kind (``all_gather_into_tensor`` -> all-gather,
    ``all_reduce`` -> all-reduce, ``reduce_scatter_tensor`` ->
    reduce-scatter, ``all_to_all_single`` -> all-to-all; permutes ->
    collective-permute), the reference's proxy "result bytes ~= bytes
    crossing links per device" (``collective_bytes()``, the reference's
    dict: the five kinds and ``counts``);
  * peak live bytes of the local storages (``track`` the params and
    inputs first; each op's new storages are added, and subtracted when
    their storage is freed).
DTensor's own shape propagation (its ops on fake tensors of the global
shapes, ``ShardingPropagator._propagate_tensor_meta_non_cached``) is not
counted.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import (CROSS_ATTN, RECURRENT, RWKV,
                                      ModelConfig)
from repro_torch.launch.shapes import InputShape

PEAK_FLOPS = 989e12        # bf16 (and fp16) on the tensor cores
TF32_FLOPS = 495e12        # TF32 on the tensor cores
F32_FLOPS = 67e12          # f32 on the CUDA cores
HBM_BW = 3.35e12           # bytes/s of HBM3
LINK_BW = 900e9            # bytes/s of NVLink to the host's other cards


COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_COLLECTIVE_NAMES = (("all_gather", "all-gather"),
                     ("all_reduce", "all-reduce"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("all_to_all", "all-to-all"),
                     ("permute", "collective-permute"))


def _collective_kind(func):
    """The kind of a ``c10d_functional`` collective op, else None."""
    ns = func.namespace
    if "c10d_functional" not in ns:
        return None
    name = func._overloadpacket.__name__
    for key, kind in _COLLECTIVE_NAMES:
        if key in name:
            return kind
    return None


def _tensors(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


class TraceCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes, collective bytes and peak live bytes of
    the local ops run under it (module docstring)."""

    _SKIP = ("empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "wait_tensor",
             "_local_scalar_dense")

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: 0.0 for k in COLLECTIVE_OPS}
        self.counts = {k: 0 for k in COLLECTIVE_OPS}
        self.live = 0
        self.peak = 0
        self._storages = {}
        self._propagating = 0
        self._restore = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, op_schema):
            self._propagating += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._propagating -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._restore = lambda: setattr(
            ShardingPropagator, "_propagate_tensor_meta_non_cached", orig)
        return super().__enter__()

    def __exit__(self, *exc):
        self._restore()
        return super().__exit__(*exc)

    def track(self, tree) -> None:
        """Count the storages of the tensors of ``tree`` (DTensors: their
        local shards) as live from now on."""
        from torch.distributed.tensor import DTensor
        for x in _tensors(tree):
            self._add(x.to_local() if isinstance(x, DTensor) else x)

    def _add(self, x) -> None:
        st = x.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()

        def gone(_, key=key, n=n):
            self._storages.pop(key, None)
            self.live -= n
        self._storages[key] = weakref.ref(st, gone)
        self.live += n
        self.peak = max(self.peak, self.live)

    def collective_bytes(self) -> dict:
        """The reference's ``collective_bytes_from_hlo`` dict."""
        return dict(self.collectives, counts=dict(self.counts))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs first, on local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._propagating:
            return out                 # DTensor's shape propagation
        kind = _collective_kind(func)
        outs = _tensors(out)
        if kind is not None:
            self.collectives[kind] += sum(_nbytes(x) for x in outs)
            self.counts[kind] += 1
        elif not func.is_view \
                and func._overloadpacket.__name__ not in self._SKIP:
            packet = func._overloadpacket
            if packet in flop_registry:
                shape = (lambda x: x.shape
                         if isinstance(x, torch.Tensor) else x)
                a, k, o = torch.utils._pytree.tree_map(
                    shape, (args, kwargs, out))
                self.flops += flop_registry[packet](*a, **k, out_val=o)
            self.bytes += sum(_nbytes(x) for x in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(x) for x in outs)
        for x in outs:
            self._add(x)
        return out


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    flops_ratio: float = 0.0     # model FLOPs / (FLOPs * chips)

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, chips: int,
                   model_flops: float = 0.0) -> Roofline:
    compute = flops_per_device / PEAK_FLOPS
    memory = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW
    terms = {"compute": compute, "memory": memory, "collective": collective}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops_per_device * chips
    return Roofline(
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=collective_bytes_per_device,
        chips=chips,
        compute_s=compute,
        memory_s=memory,
        collective_s=collective,
        bottleneck=bottleneck,
        model_flops=model_flops,
        flops_ratio=model_flops / total_flops if total_flops else 0.0,
    )


def count_params(cfg: ModelConfig) -> tuple:
    """(total_params, active_params) from the config (analytic)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    H, KV, hd, dff = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    total = V * d   # embedding
    active = V * d
    if not cfg.tie_embeddings:
        total += d * V
        active += d * V
    for i in range(L):
        kind = cfg.layer_kind(i)
        if kind == RWKV:
            tm = 4 * d * H * hd + H * hd * d + d * (5 * 32) + 5 * 32 * d \
                + d * 64 + 64 * d
            cm = d * dff + dff * d + d * d
            total += tm + cm
            active += tm + cm
            continue
        if kind == RECURRENT:
            lru = cfg.lru_width or d
            rec = 2 * d * lru + 2 * lru * lru + lru * d
            mlp = 3 * d * dff
            total += rec + mlp
            active += rec + mlp
            continue
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        total += attn
        active += attn
        if kind == CROSS_ATTN or not cfg.num_experts:
            mlp = 3 * d * dff
            total += mlp
            active += mlp
        else:
            E, k = cfg.num_experts, cfg.experts_per_token
            total += E * 3 * d * dff + d * E
            active += k * 3 * d * dff + d * E
            if cfg.num_shared_experts:
                sh = 3 * d * (cfg.num_shared_experts * dff)
                total += sh
                active += sh
            if cfg.moe_dense_ff:
                dr = 3 * d * cfg.moe_dense_ff
                total += dr
                active += dr
    return total, active


def model_flops(cfg: ModelConfig, shape: InputShape, kind: str) -> float:
    """6 N_active D for training, 2 N_active D for one forward/decode."""
    _, active = count_params(cfg)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    tokens = shape.global_batch          # one new token each
    return 2.0 * active * tokens
