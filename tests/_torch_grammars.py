"""The random-architecture grammars, without JAX.

A copy of the generators of tests/test_random_torch_graphs.py (the eleven
grammars, their activations and residual block) and of
scripts/graph_hunt.py (``_rich_net``, ``_rnn_net`` and the ``KINDS``
table), so that the port's hunt and fuzz (scripts/torch_graph_hunt.py,
scripts/torch_semantic_fuzz.py) run where JAX is not installed. Each
generator takes a ``numpy.random.Generator`` and returns ``(module,
args)``: a torch module and its example inputs. Uses numpy and torch only;
tests/test_torch_grammars.py holds each grammar's export to the original's,
byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

ATOL = 5e-4  # deep random stacks accumulate a little more than 1e-4


_ACTIVATIONS = [
    nn.ReLU, nn.GELU, nn.SiLU, nn.Hardswish, nn.ELU, nn.Tanh, nn.LeakyReLU,
    nn.Sigmoid, nn.Softplus, nn.Mish,
]


class _Residual(nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return x + self.inner(x)


def _random_conv_net(rng: np.random.Generator):
    """Sample a small 2-D CNN: conv/norm/act/pool blocks with occasional
    residuals, closed by GAP + linear head."""
    c = int(rng.choice([1, 3]))
    h = int(rng.choice([17, 24, 32]))
    w = int(rng.choice([19, 24, 33]))
    layers = []
    ch = c
    spatial = (h, w)
    for _ in range(int(rng.integers(2, 5))):
        out_ch = int(rng.choice([4, 8, 12, 16]))
        k = int(rng.choice([1, 3, 5]))
        stride = int(rng.choice([1, 1, 2]))
        pad = int(rng.integers(0, (k + 1) // 2 + 1))
        groups = 1
        if ch == out_ch and rng.random() < 0.3:
            groups = ch  # depthwise
        dil = int(rng.choice([1, 1, 2])) if stride == 1 else 1
        eff_k = (k - 1) * dil + 1
        if spatial[0] + 2 * pad < eff_k or spatial[1] + 2 * pad < eff_k:
            continue
        layers.append(nn.Conv2d(ch, out_ch, k, stride=stride, padding=pad,
                                dilation=dil, groups=groups,
                                bias=bool(rng.random() < 0.7)))
        spatial = tuple(
            (s + 2 * pad - eff_k) // stride + 1 for s in spatial
        )
        ch = out_ch
        norm_pick = rng.random()
        if norm_pick < 0.4:
            bn = nn.BatchNorm2d(ch)
            # randomize the running stats so folding is non-trivial
            bn.running_mean.data = torch.randn(ch) * 0.2
            bn.running_var.data = torch.rand(ch) + 0.5
            layers.append(bn)
        elif norm_pick < 0.55 and ch % 4 == 0:
            layers.append(nn.GroupNorm(4, ch))
        layers.append(_ACTIVATIONS[int(rng.integers(len(_ACTIVATIONS)))]())
        if rng.random() < 0.3 and min(spatial) >= 4:
            pool = nn.MaxPool2d if rng.random() < 0.5 else nn.AvgPool2d
            layers.append(pool(2, ceil_mode=bool(rng.random() < 0.5)))
            s0 = spatial
            up = 1 if layers[-1].ceil_mode else 0
            spatial = tuple((s - 2 + (1 if up else 0)) // 2 + 1 for s in s0)
        if rng.random() < 0.25:
            inner = nn.Sequential(
                nn.Conv2d(ch, ch, 3, padding=1),
                _ACTIVATIONS[int(rng.integers(len(_ACTIVATIONS)))](),
            )
            layers.append(_Residual(inner))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.body = nn.Sequential(*layers)
            self.head = nn.Linear(ch, int(rng.integers(3, 9)))

        def forward(self, x):
            z = self.body(x)
            return self.head(z.mean(dim=(2, 3)))

    b = int(rng.choice([1, 2, 3]))
    return Net(), (torch.randn(b, c, h, w),)


def _random_mlp(rng: np.random.Generator):
    """Sample an MLP with norm layers, dropout (eval no-op), and splits."""
    d = int(rng.choice([7, 16, 33]))
    layers = []
    width = d
    for _ in range(int(rng.integers(2, 6))):
        out = int(rng.choice([8, 16, 24]))
        layers.append(nn.Linear(width, out))
        width = out
        if rng.random() < 0.4:
            layers.append(nn.LayerNorm(width))
        layers.append(_ACTIVATIONS[int(rng.integers(len(_ACTIVATIONS)))]())
        if rng.random() < 0.3:
            layers.append(nn.Dropout(0.5))  # identity in eval

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.body = nn.Sequential(*layers)

        def forward(self, x):
            z = self.body(x)
            a, b = z.chunk(2, dim=-1)
            return torch.cat([torch.softmax(a, dim=-1), torch.tanh(b)], -1)

    b = int(rng.choice([1, 4]))
    return Net(), (torch.randn(b, d),)


def _random_conv1d_net(rng: np.random.Generator):
    """Audio-shaped 1-D stacks (the BirdNET frontend family), including
    large-stride single-channel convs that trigger the polyphase lowering."""
    t = int(rng.choice([2000, 4096]))
    layers = []
    ch = 1
    length = t
    first = True
    for _ in range(int(rng.integers(2, 4))):
        out_ch = int(rng.choice([4, 8, 16]))
        if first and rng.random() < 0.5:
            k, stride = 64, 32  # polyphase-eligible frontend shape
        else:
            k = int(rng.choice([3, 5, 9]))
            stride = int(rng.choice([1, 2]))
        pad = int(rng.integers(0, k // 2 + 1))
        if length + 2 * pad < k:
            continue
        layers.append(nn.Conv1d(ch, out_ch, k, stride=stride, padding=pad,
                                bias=bool(rng.random() < 0.7)))
        length = (length + 2 * pad - k) // stride + 1
        ch = out_ch
        layers.append(_ACTIVATIONS[int(rng.integers(len(_ACTIVATIONS)))]())
        first = False

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.body = nn.Sequential(*layers)

        def forward(self, x):
            z = self.body(x.unsqueeze(1))
            return torch.log1p(z * z).mean(dim=2)

    b = int(rng.choice([1, 2]))
    return Net(), (torch.randn(b, t),)


def _transformer_net(rng: np.random.Generator):
    """Attention stacks: token embedding + learned positions feeding either
    nn.TransformerEncoderLayer blocks or a hand-rolled MHA block (exports
    the raw MatMul/Softmax/Transpose/Reshape spelling), mean-pool or
    last-token head. Exercises Gather (embedding), Erf (gelu), LayerNorm,
    Softmax, Where (causal mask), batched MatMul."""
    t = int(rng.choice([7, 12, 16]))
    heads = int(rng.choice([1, 2, 4]))
    d = heads * int(rng.choice([4, 8]))
    vocab = int(rng.integers(11, 40))
    n_layers = int(rng.choice([1, 2]))
    hand_rolled = bool(rng.random() < 0.5)
    causal = bool(rng.random() < 0.5)
    norm_first = bool(rng.random() < 0.5)
    act = str(rng.choice(["gelu", "relu"]))

    class HandBlock(nn.Module):
        def __init__(self):
            super().__init__()
            self.qkv = nn.Linear(d, 3 * d)
            self.proj = nn.Linear(d, d)
            self.ln1 = nn.LayerNorm(d)
            self.ln2 = nn.LayerNorm(d)
            self.mlp = nn.Sequential(
                nn.Linear(d, 2 * d),
                nn.GELU() if act == "gelu" else nn.ReLU(),
                nn.Linear(2 * d, d),
            )

        def forward(self, x):
            b, s, _ = x.shape
            h = self.ln1(x) if norm_first else x
            q, k, v = self.qkv(h).chunk(3, dim=-1)
            q = q.view(b, s, heads, d // heads).transpose(1, 2)
            k = k.view(b, s, heads, d // heads).transpose(1, 2)
            v = v.view(b, s, heads, d // heads).transpose(1, 2)
            attn = (q @ k.transpose(-2, -1)) / float(d // heads) ** 0.5
            if causal:
                mask = torch.triu(
                    torch.ones(s, s, dtype=torch.bool), diagonal=1
                )
                attn = attn.masked_fill(mask, float("-inf"))
            z = torch.softmax(attn, dim=-1) @ v
            z = z.transpose(1, 2).reshape(b, s, d)
            x = x + self.proj(z)
            h2 = self.ln2(x) if norm_first else x
            x = x + self.mlp(h2)
            if not norm_first:
                x = self.ln2(x)
            return x

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(vocab, d)
            self.pos = nn.Embedding(t, d)
            if hand_rolled:
                self.blocks = nn.ModuleList(
                    [HandBlock() for _ in range(n_layers)]
                )
            else:
                self.blocks = nn.ModuleList([
                    nn.TransformerEncoderLayer(
                        d, heads, dim_feedforward=2 * d, dropout=0.0,
                        activation=act, batch_first=True,
                        norm_first=norm_first,
                    )
                    for _ in range(n_layers)
                ])
            self.head = nn.Linear(d, int(rng.integers(3, 9)))
            self.mean_pool = bool(rng.random() < 0.5)

        def forward(self, ids):
            x = self.emb(ids) + self.pos(
                torch.arange(ids.shape[1], dtype=torch.long)
            )
            for blk in self.blocks:
                x = blk(x)
            x = x.mean(dim=1) if self.mean_pool else x[:, -1]
            return self.head(x)

    b = int(rng.choice([1, 2]))
    ids = torch.from_numpy(
        rng.integers(0, vocab, size=(b, t)).astype(np.int64)
    )
    return Net(), (ids,)


def _control_flow_net(rng: np.random.Generator):
    """Scripted control flow: torch.jit.script exports data-dependent If
    and Loop nodes (trip-count form, while form, and the combined
    trip+cond form). Templates with randomized widths, trip counts,
    thresholds, and branch bodies; shapes stay static across iterations
    (the compiler's contract)."""
    d = int(rng.choice([5, 8, 12]))
    n = int(rng.integers(2, 6))
    thresh = float(rng.uniform(-1.0, 1.0))
    pick = int(rng.integers(0, 5))

    if pick == 0:
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.a = nn.Linear(d, d)
                self.b = nn.Linear(d, d)
                self.t = thresh

            def forward(self, x):
                if x.sum() > self.t:
                    y = torch.tanh(self.a(x))
                else:
                    y = torch.relu(self.b(x)) - 1.0
                return y * 2.0
    elif pick == 1:
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(d, d)
                self.n = n

            def forward(self, x):
                y = x
                for _ in range(self.n):
                    y = torch.tanh(self.fc(y)) + x
                return y
    elif pick == 2:
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.n = n
                self.t = abs(thresh) * 10.0 + 1.0

            def forward(self, x):
                y = x
                i = 0
                # while form: exports Loop with a live condition
                while y.abs().sum() < self.t and i < self.n * 3:
                    y = y * 1.5 + 0.1
                    i = i + 1
                return y
    elif pick == 3:
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(d, d)
                self.n = n
                self.t = thresh

            def forward(self, x):
                y = x
                for _ in range(self.n):
                    # if nested inside the loop body
                    if y.mean() > self.t:
                        y = self.fc(y) * 0.5
                    else:
                        y = y + 1.0
                return y
    else:
        class Net(nn.Module):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(d, d)
                self.n = n

            def forward(self, x):
                # two loop-carried tensors
                y = x
                acc = torch.zeros_like(x)
                for _ in range(self.n):
                    y = torch.sigmoid(self.fc(y))
                    acc = acc + y
                return acc / float(self.n)

    b = int(rng.choice([1, 2]))
    module = torch.jit.script(Net().eval())
    return module, (torch.randn(b, d),)


def _random_index_net(rng: np.random.Generator):
    """Index/permutation ops: TopK, argsort→gather, cumsum, flip, roll
    (Slice+Concat spelling), masked_fill/where, sort values, clamp,
    index_select with constant indices. These exercise the int64 index
    plumbing (Gather/GatherElements/Scatter spellings) that the conv/mlp
    grammars never touch."""
    t = int(rng.choice([9, 14, 23]))
    n_ops = int(rng.integers(2, 5))
    picks = [int(rng.integers(0, 8)) for _ in range(n_ops)]
    k = int(rng.integers(1, min(6, t)))
    shift = int(rng.integers(1, t))
    thresh = float(rng.uniform(-0.5, 0.5))
    idx = torch.from_numpy(
        rng.integers(0, t, size=int(rng.integers(2, t))).astype(np.int64)
    )

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("idx", idx)

        def forward(self, x):
            y = x
            for p in picks:
                if p == 0:
                    # Tie-break jitter: ONNX TopK specifies lower-index-
                    # first on ties (which we implement); torch eager topk
                    # does not, so tied inputs would diverge at the oracle,
                    # not in the compiler.
                    yj = y + torch.arange(
                        y.shape[-1], dtype=torch.float32
                    ) * 1e-3
                    vals, ids = torch.topk(yj, k, dim=-1)
                    y = torch.cat(
                        [vals, ids.to(torch.float32)], dim=-1
                    )
                elif p == 1:
                    order = torch.argsort(y, dim=-1, descending=True)
                    y = torch.gather(y, -1, order)
                elif p == 2:
                    y = torch.cumsum(y, dim=-1)
                elif p == 3:
                    y = torch.flip(y, dims=[-1])
                elif p == 4:
                    y = torch.roll(y, shifts=shift % y.shape[-1], dims=-1)
                elif p == 5:
                    y = y.masked_fill(y > thresh, -1.0)
                elif p == 6:
                    # descending: torch's opset-9 export of *ascending*
                    # sort emits a bare TopK (largest-first per spec) with
                    # no reversal — the exporter, not the compiler, drops
                    # the order. Descending exports faithfully everywhere.
                    y = torch.sort(y, dim=-1, descending=True)[0]
                else:
                    y = torch.index_select(
                        y, -1, self.idx.clamp(max=y.shape[-1] - 1)
                    )
                y = torch.clamp(y, -8.0, 8.0)
            return y.sum(dim=-1) + y.mean(dim=-1)

    b = int(rng.choice([1, 2]))
    return Net(), (torch.randn(b, t),)


def _random_shape_net(rng: np.random.Generator):
    """View gymnastics: permute/reshape/flatten/squeeze/unsqueeze/chunk+cat/
    stack/narrow/repeat chains — where Reshape/Transpose/Slice/Concat
    shape bookkeeping bugs live. Element count is invariant so any legal
    factorization is a valid reshape target."""
    dims = [int(rng.choice([2, 3, 4])) for _ in range(3)]
    n_ops = int(rng.integers(3, 7))
    seq = [int(rng.integers(0, 7)) for _ in range(n_ops)]

    def factorize(n, parts, rng):
        out = []
        for _ in range(parts - 1):
            divs = [d for d in range(1, n + 1) if n % d == 0]
            d = int(rng.choice(divs))
            out.append(d)
            n //= d
        out.append(n)
        return out

    shapes = []  # precomputed reshape targets per step (trace-time shapes)
    total = 1
    for d in dims:
        total *= d
    for p in seq:
        if p == 2:
            shapes.append(factorize(total, int(rng.integers(2, 5)), rng))
        else:
            shapes.append(None)

    class Net(nn.Module):
        def forward(self, x):
            y = x  # [*dims] per sample; batch handled by leading dim
            step = 0
            for p in seq:
                if p == 0:
                    perm = list(range(y.dim()))
                    perm = perm[:1] + perm[1:][::-1]
                    y = y.permute(perm).contiguous()
                elif p == 1:
                    y = y.flatten(start_dim=1)
                elif p == 2:
                    y = y.reshape([y.shape[0]] + shapes[step])
                elif p == 3:
                    y = y.unsqueeze(1).squeeze(1)
                elif p == 4:
                    parts = y.chunk(2, dim=-1)
                    y = torch.cat([parts[-1]] + list(parts[:-1]), dim=-1)
                elif p == 5:
                    y = torch.stack([y, -y], dim=1).sum(dim=1)
                else:
                    y = y.narrow(-1, 0, max(1, y.shape[-1] - 1))
                    y = torch.cat([y, y[..., :1]], dim=-1)
                y = y * 1.01 + 0.1
                step += 1
            return y.flatten(start_dim=1).sum(dim=-1)

    b = int(rng.choice([1, 2]))
    return Net(), (torch.randn(b, *dims),)


def _random_reduce_net(rng: np.random.Generator):
    """Reduction chains: sum/mean/amax/amin/logsumexp/var/std/norm over
    random axes with random keepdim, interleaved with softmax/log_softmax
    and elementwise ops — exercises the Reduce* family's axes/keepdims
    plumbing and the LogSoftmax coercions."""
    shape = [int(rng.choice([3, 4, 5])) for _ in range(int(rng.choice([2, 3])))]
    n_ops = int(rng.integers(2, 5))
    plan = []
    cur = list(shape)
    for _ in range(n_ops):
        p = int(rng.integers(0, 9))
        ax = int(rng.integers(0, len(cur))) if cur else 0
        keep = bool(rng.random() < 0.5)
        if not cur:
            break
        plan.append((p, ax, keep))
        if p < 7 and not keep:
            cur.pop(ax)
    reducers = ["sum", "mean", "amax", "amin", "logsumexp", "var", "std"]

    class Net(nn.Module):
        def forward(self, x):
            y = x
            for p, ax, keep in plan:
                a = ax + 1  # axis 0 is batch
                if p < 7:
                    name = reducers[p]
                    if name == "var":
                        y = torch.var(y, dim=a, keepdim=keep, correction=1)
                    elif name == "std":
                        y = torch.std(y, dim=a, keepdim=keep, correction=1)
                    elif name == "logsumexp":
                        y = torch.logsumexp(y, dim=a, keepdim=keep)
                    else:
                        y = getattr(torch, name)(y, dim=a, keepdim=keep)
                elif p == 7:
                    y = torch.softmax(y, dim=a)
                else:
                    y = torch.log_softmax(y, dim=a)
                y = y * 0.9 + 0.05
            return y.flatten(start_dim=1).sum(dim=-1) if y.dim() > 1 else y

    b = int(rng.choice([1, 2]))
    return Net(), (torch.randn(b, *shape),)


def _ast_net(rng: np.random.Generator):
    """Audio-spectrogram-transformer shape: Conv2d patch embedding over a
    [B, 1, H, W] spectrogram, flatten patches to a sequence, transformer
    encoder blocks, mean-pool head — the conv→reshape→transpose→attention
    boundary that pure-CNN and pure-transformer grammars never cross."""
    hw = int(rng.choice([16, 24]))
    patch = int(rng.choice([4, 8]))
    heads = int(rng.choice([1, 2]))
    d = heads * int(rng.choice([8, 16]))
    n_layers = int(rng.choice([1, 2]))
    act = str(rng.choice(["gelu", "relu"]))
    cls_token = bool(rng.random() < 0.5)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = nn.Conv2d(1, d, patch, stride=patch)
            n_patches = (hw // patch) ** 2
            self.pos = nn.Parameter(
                torch.randn(1, n_patches + (1 if cls_token else 0), d) * 0.02
            )
            if cls_token:
                self.cls = nn.Parameter(torch.zeros(1, 1, d))
            self.blocks = nn.ModuleList([
                nn.TransformerEncoderLayer(
                    d, heads, dim_feedforward=2 * d, dropout=0.0,
                    activation=act, batch_first=True, norm_first=True,
                )
                for _ in range(n_layers)
            ])
            self.norm = nn.LayerNorm(d)
            self.head = nn.Linear(d, int(rng.integers(3, 9)))
            self.use_cls = cls_token

        def forward(self, x):
            z = self.embed(x)                      # [B, d, H', W']
            z = z.flatten(2).transpose(1, 2)       # [B, P, d]
            if self.use_cls:
                cls = self.cls.expand(z.shape[0], -1, -1)
                z = torch.cat([cls, z], dim=1)
            z = z + self.pos
            for blk in self.blocks:
                z = blk(z)
            z = self.norm(z)
            z = z[:, 0] if self.use_cls else z.mean(dim=1)
            return self.head(z)

    b = int(rng.choice([1, 2]))
    return Net(), (torch.randn(b, 1, hw, hw),)


def _random_dtype_net(rng: np.random.Generator):
    """Mixed dtypes and multiple inputs: a float tensor and an int64
    tensor combine through casts, comparisons, boolean logic, where,
    integer arithmetic (floor-div/mod/clamp), and one-hot-style
    equality — the Cast/Greater/And/Where/Div-on-int plumbing that
    single-float-input grammars never reach."""
    t = int(rng.choice([8, 13, 20]))
    hi = int(rng.integers(3, 9))
    n_ops = int(rng.integers(2, 5))
    picks = [int(rng.integers(0, 6)) for _ in range(n_ops)]
    thresh = float(rng.uniform(-0.5, 0.5))
    modulus = int(rng.integers(2, 5))

    class Net(nn.Module):
        def forward(self, x, ids):
            y = x
            k = ids
            for p in picks:
                if p == 0:
                    y = torch.where(y > thresh, y, k.to(torch.float32))
                elif p == 1:
                    mask = (k % modulus == 0) & (y < 1.0)
                    y = y + mask.to(torch.float32)
                elif p == 2:
                    k = torch.div(k + 1, modulus, rounding_mode="floor")
                    y = y * 0.9
                elif p == 3:
                    y = y + (k == k.flip(dims=[-1])).to(y.dtype)
                elif p == 4:
                    k = torch.clamp(k - 1, min=0, max=hi - 1)
                    y = y - k.to(torch.float32) * 0.1
                else:
                    big = (y.abs() > 0.5) | (k > hi // 2)
                    y = torch.where(big, -y, y * 2.0)
            return y.sum(dim=-1) + k.to(torch.float32).sum(dim=-1)

    b = int(rng.choice([1, 2]))
    ids = torch.from_numpy(
        rng.integers(0, hi, size=(b, t)).astype(np.int64)
    )
    return Net(), (torch.randn(b, t), ids)


def _kv_decode_net(rng: np.random.Generator):
    """Random single decoder step with an explicit KV cache: past K/V as
    graph inputs, updated presents as extra outputs, a short query
    attending over concat(past, new) under a causal (optionally sliding-
    window) mask. Randomizes grouped-query attention fan-out, rotary vs
    no positional mixing, and RMSNorm vs LayerNorm — the incremental-
    generation protocol probed end-to-end in test_kv_cache_decode.py,
    here as a fuzz grammar."""
    n_kv = int(rng.choice([1, 2]))
    group = int(rng.choice([1, 2]))
    n_heads = n_kv * group
    hd = int(rng.choice([8, 16]))
    d = n_heads * hd
    past_len = int(rng.choice([0, 3, 5]))
    q_len = int(rng.choice([1, 2]))
    b = int(rng.choice([1, 2]))
    use_rope = bool(rng.random() < 0.5)
    use_rms = bool(rng.random() < 0.5)
    window = int(rng.choice([0, 4]))  # 0 = full causal

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.qp = torch.nn.Linear(d, n_heads * hd)
            self.kp = torch.nn.Linear(d, n_kv * hd)
            self.vp = torch.nn.Linear(d, n_kv * hd)
            self.op = torch.nn.Linear(n_heads * hd, d)
            self.norm = torch.nn.LayerNorm(d)

        @staticmethod
        def _rope(x, pos):
            half = hd // 2
            inv = 1.0 / (10000.0 ** (
                torch.arange(0, half, dtype=torch.float32) / half))
            ang = pos[:, None].to(torch.float32) * inv[None, :]
            cos, sin = torch.cos(ang), torch.sin(ang)
            x1, x2 = x[..., :half], x[..., half:]
            return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                             dim=-1)

        def forward(self, x, pk, pv):
            h = (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6)
                 if use_rms else self.norm(x))
            q = self.qp(h).view(b, q_len, n_heads, hd).transpose(1, 2)
            k = self.kp(h).view(b, q_len, n_kv, hd).transpose(1, 2)
            v = self.vp(h).view(b, q_len, n_kv, hd).transpose(1, 2)
            if use_rope:
                qpos = torch.arange(past_len, past_len + q_len)
                q = self._rope(q, qpos)
                k = self._rope(k, qpos)
            K = torch.cat([pk, k], dim=2)
            V = torch.cat([pv, v], dim=2)
            s = past_len + q_len
            Kh = K.repeat_interleave(group, dim=1)
            Vh = V.repeat_interleave(group, dim=1)
            att = (q @ Kh.transpose(-1, -2)) / (hd ** 0.5)
            qpos2 = torch.arange(past_len, past_len + q_len)[:, None]
            kpos = torch.arange(s)[None, :]
            mask = kpos <= qpos2
            if window:
                mask = mask & (kpos > qpos2 - window)
            att = att.masked_fill(~mask, float("-inf"))
            y = (torch.softmax(att, dim=-1) @ Vh).transpose(1, 2)
            y = y.reshape(b, q_len, n_heads * hd)
            return self.op(y) + x, K, V

    x = torch.randn(b, q_len, d)
    pk = torch.randn(b, n_kv, past_len, hd)
    pv = torch.randn(b, n_kv, past_len, hd)
    return Net(), (x, pk, pv)


class _Lambda(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _rich_net(rng: np.random.Generator):
    """Wider grammar: everything in the CI CNN grammar plus upsampling,
    transposed convs, pixel shuffle, functional pads, slice+concat."""
    c = int(rng.choice([1, 3, 4]))
    h = int(rng.choice([12, 17, 24]))
    w = int(rng.choice([13, 19, 24]))
    layers = []
    ch = c
    for _ in range(int(rng.integers(2, 6))):
        pick = rng.random()
        if pick < 0.35:
            out_ch = int(rng.choice([4, 8, 12]))
            k = int(rng.choice([1, 3, 5]))
            pad = int(rng.integers(0, (k + 1) // 2 + 1))
            layers.append(nn.Conv2d(ch, out_ch, k,
                                    stride=int(rng.choice([1, 2])),
                                    padding=pad,
                                    bias=bool(rng.random() < 0.7)))
            ch = out_ch
        elif pick < 0.45:
            out_ch = int(rng.choice([4, 8]))
            layers.append(nn.ConvTranspose2d(
                ch, out_ch, int(rng.choice([2, 3, 4])),
                stride=int(rng.choice([1, 2])),
                padding=int(rng.integers(0, 2)),
                output_padding=0,
            ))
            ch = out_ch
        elif pick < 0.55:
            mode = str(rng.choice(["nearest", "bilinear", "bicubic"]))
            sf = float(rng.choice([1.5, 2.0]))
            align = bool(rng.random() < 0.5) if mode != "nearest" else None
            layers.append(nn.Upsample(scale_factor=sf, mode=mode,
                                      align_corners=align))
        elif pick < 0.62 and ch % 4 == 0:
            layers.append(nn.PixelShuffle(2)) if ch % 16 == 0 else layers.append(
                nn.GroupNorm(4, ch)
            )
            if isinstance(layers[-1], nn.PixelShuffle):
                ch //= 4
        elif pick < 0.72:
            pmode = str(rng.choice(["constant", "reflect", "replicate"]))
            p = int(rng.integers(1, 3))
            layers.append(_Lambda(
                lambda z, p=p, m=pmode: torch.nn.functional.pad(
                    z, (p, p, p, p), mode=m
                )
            ))
        elif pick < 0.82:
            pool = nn.MaxPool2d if rng.random() < 0.5 else nn.AvgPool2d
            layers.append(pool(int(rng.choice([2, 3])),
                               stride=int(rng.choice([1, 2])),
                               ceil_mode=bool(rng.random() < 0.5)))
        elif pick < 0.9:
            layers.append(_Lambda(
                lambda z: torch.cat(
                    [z[..., : z.shape[-1] // 2],
                     torch.flip(z[..., z.shape[-1] // 2:], dims=[-1])], -1
                )
            ))
        else:
            layers.append(
                _ACTIVATIONS[int(rng.integers(len(_ACTIVATIONS)))]()
            )
        if rng.random() < 0.4:
            layers.append(
                _ACTIVATIONS[int(rng.integers(len(_ACTIVATIONS)))]()
            )

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.body = nn.Sequential(*layers)

        def forward(self, x):
            z = self.body(x)
            return z.float().mean(dim=(2, 3))

    b = int(rng.choice([1, 2]))
    return Net(), (torch.randn(b, c, h, w),)


def _rnn_net(rng: np.random.Generator):
    """Recurrent stacks the audio domain actually exports: Conv1d frontend
    feeding LSTM/GRU/RNN layers with optional bidirectionality."""
    t = int(rng.choice([400, 900]))
    conv_ch = int(rng.choice([4, 8]))
    hidden = int(rng.choice([8, 16]))
    kind = str(rng.choice(["lstm", "gru", "rnn"]))
    bidi = bool(rng.random() < 0.4)
    layers_n = int(rng.choice([1, 2]))

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv1d(1, conv_ch, 9, stride=4, padding=4)
            cls = {"lstm": nn.LSTM, "gru": nn.GRU, "rnn": nn.RNN}[kind]
            self.rec = cls(conv_ch, hidden, num_layers=layers_n,
                           bidirectional=bidi, batch_first=True)
            self.fc = nn.Linear(hidden * (2 if bidi else 1),
                                int(rng.integers(3, 7)))

        def forward(self, x):
            z = torch.relu(self.conv(x.unsqueeze(1)))  # [B, C, T']
            z = z.transpose(1, 2)  # [B, T', C]
            out = self.rec(z)[0]
            return self.fc(out[:, -1])

    b = int(rng.choice([1, 2]))
    return Net(), (torch.randn(b, t),)


KINDS = {
    "cnn": _random_conv_net,
    "mlp": _random_mlp,
    "conv1d": _random_conv1d_net,
    "rich": _rich_net,
    "rnn": _rnn_net,
    "xfmr": _transformer_net,
    "ctrl": _control_flow_net,
    "idx": _random_index_net,
    "shape": _random_shape_net,
    "reduce": _random_reduce_net,
    "dtype": _random_dtype_net,
    "ast": _ast_net,
    "kv": _kv_decode_net,
}
