"""The 49 int8 1x1 convs of the full-width BirdNET v2.4 forward (what kernel
B3 runs), from the stage schedule of models/birdnet_v24.py: per MBConv block
the expand (silu), the squeeze-excite pair on the pooled [C, 1, 1] map
(silu, then sigmoid; N = 1) and the project (no activation), then the head
conv (silu)."""

# (c_in, c_out, stride, expand) per stage; two blocks each at depth 2.
_STAGES = [(32, 24, 1, 1), (24, 40, 2, 4), (40, 80, 2, 4), (80, 112, 2, 4),
           (112, 192, 2, 4), (192, 320, 1, 4)]


def v24_qconv_shapes():
    """[(C_in, C_out, N, act)] in graph order, N the spatial size H * W."""
    shapes, h, w = [], 48, 256  # after the stride-2 stem on [96, 511]
    for c_in, c_out, stride, expand in _STAGES:
        for block in range(2):
            cin = c_in if block == 0 else c_out
            mid, s = cin * expand, stride if block == 0 else 1
            se = max(mid // 4, 4)
            shapes.append((cin, mid, h * w, "silu"))
            h, w = -(-h // s), -(-w // s)
            shapes += [(mid, se, 1, "silu"), (se, mid, 1, "sigmoid"), (mid, c_out, h * w, "")]
    shapes.append((320, 1280, h * w, "silu"))
    return shapes
