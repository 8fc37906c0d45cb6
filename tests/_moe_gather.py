"""The held-expert MoE's dispatch and combine as the gather formulation
that kernel K8 replaced, kept by the tests as their own: ``moe._Dispatch``
over a zero row, the combine's f32 sum over every slot with the unheld
ones masked to +0.0, then the shared experts' add and one cast.  Used by
``test_torch_moe_rows.py`` (CPU) and ``test_torch_kernels_cuda.py``."""
import torch
import torch.nn.functional as F

from repro_torch.models import moe as M
from repro_torch.models.layers import swiglu


class _CombineGather(torch.autograd.Function):
    """The combine as a gather over every slot (the formulation K8
    replaced): y [T, d] f32 = sum over j, in slot order, of where(held,
    y_buf[pos[:, j]] w[:, j], 0); backward d y_buf = w_sorted dy[src]
    (rows of no held assignment 0), dw = <dy, y_buf[pos]> where held."""

    @staticmethod
    def forward(ctx, y_buf, w, pos, held, src, w_sorted):
        ctx.save_for_backward(y_buf, pos, held, src, w_sorted)
        y = torch.zeros((pos.shape[0], y_buf.shape[1]), dtype=torch.float32,
                        device=y_buf.device)
        for j in range(pos.shape[1]):
            y = y + torch.where(held[:, j, None],
                                y_buf[pos[:, j]].float() * w[:, j, None],
                                0.0)
        return y

    @staticmethod
    def backward(ctx, dy):
        y_buf, pos, held, src, w_sorted = ctx.saved_tensors
        dw = torch.stack([torch.where(held[:, j], (dy * y_buf[pos[:, j]]
                                                   .float()).sum(-1), 0.0)
                          for j in range(pos.shape[1])], dim=1)
        dy_pad = torch.cat([dy, dy.new_zeros((1, dy.shape[1]))], dim=0)
        d_buf = (dy_pad[src] * w_sorted[:, None]).to(y_buf.dtype)
        return d_buf, dw, None, None, None, None


def gather_layout(experts, w, lo, nh):
    """The gather formulation's layout: (slot [T, k], src [N] (T where a
    row holds no held assignment), offs, pos [T, k], held [T, k],
    w_sorted [N])."""
    Tn, k = experts.shape
    N = Tn * k
    local = experts.reshape(-1) - lo
    held = (local >= 0) & (local < nh)
    key = torch.where(held, local, nh)
    order = torch.argsort(key, stable=True)
    counts = M._counts(key, nh + 1, torch.long)
    offs = torch.cumsum(counts[:nh], 0).to(torch.int32)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(N, device=experts.device)
    slot = torch.where(held, rank, N)
    token = torch.arange(N, device=experts.device) // k
    src = torch.where(held[order], token[order], Tn)
    w_sorted = torch.where(held, w.detach().reshape(-1), 0.0)[order]
    return (slot.reshape(Tn, k), src, offs,
            torch.where(held, rank, 0).reshape(Tn, k), held.reshape(Tn, k),
            w_sorted)


def routing(case, Tn, E, k, nh, gen, device="cpu"):
    """experts [T, k] over E and weights [T, k] f32 from ``gen``: the held
    experts [0, nh) take some assignments ("seeded"), none ("none_held")
    or all ("all_held")."""
    scores = torch.rand((Tn, E), generator=gen)
    if case == "none_held":
        scores[:, :nh] -= 2.0
    elif case == "all_held":
        scores[:, :nh] += 2.0
    experts = torch.sort(scores, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    w = torch.rand((Tn, k), generator=gen) + 0.1
    return experts.to(device), w.to(device)


def gather_moe_ffn_held(params, cfg, x):
    """``moe.moe_ffn_held`` as the gather formulation computed it."""
    B, S, d = x.shape
    Tn, k = B * S, cfg.experts_per_token
    nh = cfg.num_held
    xf = x.reshape(Tn, d)
    logits = M.matmul(xf.to(torch.float32), params["router"])
    w, experts = M.sigmoid_routing(logits, params["router_bias"], k,
                                   cfg.routed_scaling)
    slot, src, offs, pos, held, w_sorted = gather_layout(
        experts, w, cfg.expert_lo, nh)
    x_buf = M._Dispatch.apply(xf, src, slot)
    h = F.silu(M.grouped_mm(x_buf, params["w_gate"], offs)) \
        * M.grouped_mm(x_buf, params["w_up"], offs)
    y_buf = M.grouped_mm(h, params["w_down"], offs)
    y = _CombineGather.apply(y_buf, w, pos, held, src, w_sorted)
    y = y + swiglu(params["shared"], x).reshape(Tn, d).float()
    return y.to(x.dtype).reshape(B, S, d)
