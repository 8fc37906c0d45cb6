"""ResNet18-GN's forward FLOPs for one image, counted from its layers'
shapes: a convolution 2 * C_in * C_out * k^2 * H_out * W_out, the head
2 * 512 * classes (norms, activations and the pool not counted).  At the
CIFAR stem and 32 x 32 images: 1,110,937,600 (the table in PERF.md)."""
from __future__ import annotations


def layers(model: dict):
    """(name, C_in, C_out, k, H_out, W_out) of every convolution, then the
    head as a 1 x 1 product."""
    widths = model["stage_widths"]
    s = model["image_size"]
    out = [("stem", model["channels"], widths[0], 3, s, s)]
    cin = widths[0]
    for si, cout in enumerate(widths):
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            s = -(-s // stride)
            out.append((f"s{si}b{bi}.conv1", cin, cout, 3, s, s))
            out.append((f"s{si}b{bi}.conv2", cout, cout, 3, s, s))
            if stride != 1 or cin != cout:
                out.append((f"s{si}b{bi}.proj", cin, cout, 1, s, s))
            cin = cout
    out.append(("fc", cin, model["num_classes"], 1, 1, 1))
    return out


def forward_flops(model: dict) -> float:
    return float(sum(2 * ci * co * k * k * h * w
                     for _, ci, co, k, h, w in layers(model)))
