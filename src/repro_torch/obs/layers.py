"""``LayerTrace``: what a train step's layers report beside their
outputs (``fl.distributed.make_train_step`` makes one a step; the layers
of kind ``MLA`` / ``MLA_DENSE``, ``models/mla.py`` and
``models/moe.moe_ffn_held``, report to it, and every other layer leaves
it alone)."""
from __future__ import annotations

import torch

from repro_torch.obs.core import DISABLED


def in_backward() -> bool:
    """True while autograd's engine runs a backward (a checkpointed
    layer's recompute among it)."""
    return torch._C._current_graph_task_id() != -1


class LayerTrace:
    """A train step's per-layer reports: with a live ``obs``, spans of
    each layer's attention and MoE (``lm.mla``, ``lm.moe``, and inside the
    MoE ``lm.moe.route`` and ``lm.moe.experts``; forward and remat
    recompute) and their backward (``lm.mla_bwd``, ``lm.moe_bwd``, opened
    and closed by gradient hooks); always the MoE counters of the forward
    (``moe``: a (assignments to held experts, the largest held expert's
    count) pair of device tensors a layer); with ``routing`` a list, each
    MoE layer's expert choices [tokens, k] (int16, on the device) of the
    forward.  A recompute adds spans and nothing else.  With ``obs`` off
    it opens no span and registers no hook."""

    def __init__(self, obs=DISABLED, device=None, routing=None):
        self.obs = obs
        self.device = device
        self.moe = []
        self.routing = routing

    def span(self, name):
        return self.obs.device_span(name, self.device)

    def backward_span(self, name, start, end):
        """A span ``name`` from the gradient's arrival at ``start`` to its
        arrival at ``end`` (hooks registered in the forward only)."""
        if not self.obs.enabled or in_backward() \
                or not (start.requires_grad and end.requires_grad):
            return
        begin, finish = self.obs.tracer.grad_span_hooks(name, self.device)
        end.register_hook(finish)
        start.register_hook(begin)
