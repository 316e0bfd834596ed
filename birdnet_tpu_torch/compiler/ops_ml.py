"""The ``ai.onnx.ml`` domain: the classical-ML operator set.

The counterpart of :mod:`birdnet_tpu.compiler.ops_ml`, section by section,
registered with ``contrib_op("ai.onnx.ml", ...)``:

- **Numeric compute is torch** (Scaler, Normalizer, Binarizer, Imputer,
  the linear, tree and SVM models, numeric OneHotEncoder and
  LabelEncoder) and runs on the input's device with no host read.
- **Strings and maps are host values** (numpy object arrays, dicts and
  lists of dicts in the interpreter's environment): ZipMap,
  DictVectorizer, CastMap, CategoryMapper and the string paths of the
  encoders and classifiers run on the host. A CPU tensor there is read;
  a tensor on the card raises ``NotImplementedError``, as a tracer does
  in the JAX lowering. A classifier whose label output the graph never
  binds computes no labels (``OpContext.wants_output``).

Post-transforms follow the ORT kernels: NONE, SOFTMAX, LOGISTIC,
SOFTMAX_ZERO (softmax over the nonzero entries only) and PROBIT (the
inverse normal CDF).

The trees run as one vectorized descent over a [rows, trees] cursor, a
fixed number of gather steps (the forest's depth). The SVM classifier's
Platt coupling runs exactly ``max(100, k)`` iterations with converged rows
frozen: the JAX ``lax.while_loop`` stops when every row has converged, and
a frozen row's step changes nothing, so the answer is the same with no
host read.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import _checked_index, _device_of, _filled, _is_host, _tensor, contrib_op

_ML = "ai.onnx.ml"


def _ml_op(*names, fold: bool = False):
    return contrib_op(_ML, *names, fold=fold)


def _require_static(x, op_name, what="input"):
    """``x`` on the host: a host value as it is, a CPU tensor read to
    numpy; a tensor on the card raises."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise NotImplementedError(
                f"{_ML}.{op_name} {what} must be a compile-time constant "
                f"(strings and maps are host values)"
            )
        return x.detach().numpy()
    return x


def _f32(ctx, x) -> torch.Tensor:
    return _tensor(ctx, x).float()


# ---------------------------------------------------------------------------
# post-transforms (shared by the classifier/regressor family)
# ---------------------------------------------------------------------------


def _post_transform(scores, kind):
    if kind in (None, "NONE"):
        return scores
    if kind == "SOFTMAX":
        return torch.softmax(scores, dim=-1)
    if kind == "LOGISTIC":
        return torch.sigmoid(scores)
    if kind == "SOFTMAX_ZERO":
        # softmax over the nonzero entries; exact zeros get probability 0.
        nz = scores != 0
        masked = torch.where(nz, scores, torch.full_like(scores, -torch.inf))
        sm = torch.softmax(masked, dim=-1)
        return torch.where(nz, sm, torch.zeros_like(sm))
    if kind == "PROBIT":
        return torch.special.ndtri(scores)
    raise ValueError(f"invalid post_transform {kind!r}")


def _class_labels(ctx):
    """(labels array, is_string) from the classlabels_* attributes."""
    ints = ctx.attr("classlabels_int64s")
    if ints is not None:
        return np.asarray([int(v) for v in ints], dtype=np.int64), False
    strs = ctx.attr("classlabels_strings")
    if strs is not None:
        return np.asarray([str(s) for s in strs], dtype=object), True
    raise ValueError("classifier node has no classlabels_* attribute")


def _labels_of(ctx, idx, labels, is_string, op_name):
    """``labels[idx]``: on idx's device for integer labels, on the host
    for strings."""
    if not is_string:
        return _tensor(ctx, labels, idx.device)[idx]
    idx = _require_static(idx, op_name, what="input (string class labels)")
    return labels[np.asarray(idx)]


def _pick_labels(ctx, scores, labels, is_string, op_name):
    """argmax over the score columns, through the label vocabulary; None
    when the graph never binds the label output."""
    if not ctx.wants_output(0):
        return None
    return _labels_of(ctx, torch.argmax(scores, dim=-1), labels, is_string, op_name)


# ---------------------------------------------------------------------------
# feature plumbing
# ---------------------------------------------------------------------------


@_ml_op("ArrayFeatureExtractor", fold=True)
def _array_feature_extractor(ctx, x, y):
    """Gather columns of the last axis by index (the ORT semantics)."""
    if _is_host(x) and np.asarray(x).dtype.kind in ("U", "S", "O"):
        idx = np.asarray(_require_static(y, "ArrayFeatureExtractor")).reshape(-1)
        return [np.take(np.asarray(x), idx, axis=-1)]
    x = _tensor(ctx, x, _device_of(ctx, x, y))
    n = x.shape[-1]
    idx, ok = _checked_index(ctx, y, x.device, n)
    idx = idx.reshape(-1)
    out = x.index_select(x.ndim - 1, idx)
    return [_filled(out, ok, (1,) * (x.ndim - 1) + (-1,))]


@_ml_op("Binarizer", fold=True)
def _binarizer(ctx, x):
    threshold = float(ctx.attr("threshold", 0.0))
    x = _tensor(ctx, x)
    return [(x > threshold).to(x.dtype)]


@_ml_op("Scaler", fold=True)
def _scaler(ctx, x):
    x = _f32(ctx, x)
    offset = _tensor(ctx, np.asarray(list(ctx.attr("offset")), np.float32), x.device)
    scale = _tensor(ctx, np.asarray(list(ctx.attr("scale")), np.float32), x.device)
    return [(x - offset) * scale]


@_ml_op("Normalizer", fold=True)
def _normalizer(ctx, x):
    norm = str(ctx.attr("norm", "MAX"))
    x = _f32(ctx, x)
    if norm == "MAX":
        d = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    elif norm == "L1":
        d = torch.sum(torch.abs(x), dim=-1, keepdim=True)
    elif norm == "L2":
        d = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    else:
        raise ValueError(f"invalid Normalizer norm {norm!r}")
    return [x / torch.where(d == 0, torch.ones_like(d), d)]


@_ml_op("Imputer", fold=True)
def _imputer(ctx, x):
    x = _tensor(ctx, x)
    imputed_f = ctx.attr("imputed_value_floats")
    if imputed_f is not None:
        imputed = np.asarray(list(imputed_f), dtype=np.float32)
        replaced = float(ctx.attr("replaced_value_float", 0.0))
        mask = torch.isnan(x) if np.isnan(replaced) else (x == replaced)
    else:
        imputed = np.asarray([int(v) for v in ctx.attr("imputed_value_int64s")],
                             dtype=np.int64)
        replaced = int(ctx.attr("replaced_value_int64", 0))
        mask = x == replaced
    if imputed.size == 1:
        fill = imputed.reshape(())
    else:
        if x.shape[-1] != imputed.size:
            raise ValueError(
                f"Imputer has {imputed.size} imputed values but the input's "
                f"last dimension is {x.shape[-1]}"
            )
        fill = imputed
    return [torch.where(mask, _tensor(ctx, fill, x.device).to(x.dtype), x)]


@_ml_op("FeatureVectorizer", fold=True)
def _feature_vectorizer(ctx, *xs):
    """Concatenate the inputs along axis 1, each flattened to [N, -1] and
    cut or zero-padded to its ``inputdimensions`` width."""
    dims = ctx.attr("inputdimensions")
    if dims is None:
        dims = [None] * len(xs)
    device = _device_of(ctx, *xs)
    cols = []
    for x, d in zip(xs, dims):
        x = _tensor(ctx, x, device).float()
        x2 = x.reshape((x.shape[0], -1)) if x.ndim > 1 else x.reshape((1, -1))
        if d is not None:
            d = int(d)
            if x2.shape[1] >= d:
                x2 = x2[:, :d]
            else:
                x2 = torch.nn.functional.pad(x2, (0, d - x2.shape[1]))
        cols.append(x2)
    return [torch.cat(cols, dim=1)]


# ---------------------------------------------------------------------------
# encoders / mappers
# ---------------------------------------------------------------------------


@_ml_op("OneHotEncoder", fold=True)
def _one_hot_encoder(ctx, x):
    cats_i = ctx.attr("cats_int64s")
    cats_s = ctx.attr("cats_strings")
    zeros = int(ctx.attr("zeros", 1))
    if cats_s is not None:
        xv = np.asarray(_require_static(x, "OneHotEncoder", what="input (string categories)"))
        cats = [str(s) for s in cats_s]
        pos = {c: i for i, c in enumerate(cats)}
        flat = [pos.get(str(s), -1) for s in xv.reshape(-1)]
        if not zeros and -1 in flat:
            raise ValueError("OneHotEncoder (zeros=0): input value not in cats")
        out = np.zeros((len(flat), len(cats)), np.float32)
        for r, c in enumerate(flat):
            if c >= 0:
                out[r, c] = 1.0
        return [out.reshape(xv.shape + (len(cats),))]
    cats = np.asarray([int(v) for v in cats_i], dtype=np.int64)
    if not zeros:
        # An unmatched value must fail, which only the host can check.
        _require_static(x, "OneHotEncoder", what="input (zeros=0)")
    xt = _tensor(ctx, x)
    eq = xt[..., None] == _tensor(ctx, cats, xt.device).to(xt.dtype)
    if not zeros and bool((~eq.any(dim=-1)).any()):
        raise ValueError("OneHotEncoder (zeros=0): input value not in cats")
    return [eq.float()]


def _encoder_tables(ctx):
    """(keys, values) arrays of a LabelEncoder across its opset revisions."""
    keys = None
    for name in ("keys_int64s", "keys_floats", "keys_strings"):
        v = ctx.attr(name)
        if v is not None:
            keys = (np.asarray([str(s) for s in v], dtype=object)
                    if name == "keys_strings" else np.asarray(list(v)))
            break
    values = None
    for name in ("values_int64s", "values_floats", "values_strings"):
        v = ctx.attr(name)
        if v is not None:
            values = (np.asarray([str(s) for s in v], dtype=object)
                      if name == "values_strings" else np.asarray(list(v)))
            break
    if keys is not None and values is not None:
        return keys, values
    # LabelEncoder-4: the tables as TensorProto attributes; string tensors
    # decode to object arrays of str, numerics stay numeric.
    kt, vt = ctx.attr("keys_tensor"), ctx.attr("values_tensor")
    if kt is not None and vt is not None:
        return kt.to_numpy().reshape(-1), vt.to_numpy().reshape(-1)
    # LabelEncoder-1: classes_strings maps string -> int64 (index) and back.
    classes = ctx.attr("classes_strings")
    if classes is not None:
        strs = np.asarray([str(s) for s in classes], dtype=object)
        return strs, np.arange(len(strs), dtype=np.int64)
    raise ValueError("LabelEncoder has no keys_*/values_* tables")


def _lookup_default(ctx, values):
    dt = ctx.attr("default_tensor")
    if dt is not None:
        dv = dt.to_numpy().reshape(-1)
        if dv.size != 1:
            raise ValueError(
                f"LabelEncoder default_tensor must hold one element, got {dv.size}"
            )
        v = dv[0]
        if values.dtype.kind == "O":
            return str(v)
        return float(v) if values.dtype.kind == "f" else int(v)
    if values.dtype.kind == "O":
        return str(ctx.attr("default_string", "_Unused"))
    if values.dtype.kind == "f":
        return float(ctx.attr("default_float", -0.0))
    return int(ctx.attr("default_int64", -1))


@_ml_op("LabelEncoder", fold=True)
def _label_encoder(ctx, x):
    keys, values = _encoder_tables(ctx)
    default = _lookup_default(ctx, values)
    str_in = keys.dtype.kind == "O"
    str_out = values.dtype.kind == "O"
    if ctx.attr("classes_strings") is not None:
        # v1 picks its direction by the input's type: string -> index or
        # index -> string.
        if _is_host(x) and np.asarray(x).dtype.kind in ("U", "S", "O"):
            str_in, str_out = True, False
            default = int(ctx.attr("default_int64", -1))
        else:
            str_in, str_out = False, True
            keys, values = values, keys
            default = str(ctx.attr("default_string", "_Unused"))
    if str_in or str_out:
        xv = np.asarray(_require_static(x, "LabelEncoder", what="input (string table)"))
        table = {k: v for k, v in zip(keys.tolist(), values.tolist())}
        if str_in:
            out = [table.get(str(s), default) for s in xv.reshape(-1)]
        else:
            out = [table.get(int(s) if keys.dtype.kind == "i" else float(s), default)
                   for s in xv.reshape(-1)]
        dtype = object if str_out else (
            np.float32 if isinstance(default, float) else np.int64)
        return [np.asarray(out, dtype=dtype).reshape(xv.shape)]
    # numeric -> numeric: a compare-all lookup on the input's device.
    xt = _tensor(ctx, x)
    k = _tensor(ctx, keys.astype(np.float32 if keys.dtype.kind == "f" else np.int64),
                xt.device)
    xe = xt[..., None].to(k.dtype)
    eq = xe == k
    if k.dtype.is_floating_point:
        eq = eq | (torch.isnan(xe) & torch.isnan(k))  # a NaN key matches NaN
    vals = _tensor(ctx, values.astype(np.float32 if values.dtype.kind == "f"
                                      else np.int64), xt.device)
    hit = eq.any(dim=-1)
    first = torch.argmax(eq.to(torch.uint8), dim=-1)
    fill = torch.full((), default, dtype=vals.dtype, device=xt.device)
    return [torch.where(hit, vals[first], fill)]


@_ml_op("CategoryMapper")
def _category_mapper(ctx, x):
    cats_i = np.asarray([int(v) for v in ctx.attr("cats_int64s")], np.int64)
    cats_s = [str(s) for s in ctx.attr("cats_strings")]
    if len(cats_i) != len(cats_s):
        raise ValueError("CategoryMapper cats tables differ in length")
    xv = np.asarray(_require_static(x, "CategoryMapper"))
    if xv.dtype.kind in ("U", "S", "O"):
        table = {s: i for s, i in zip(cats_s, cats_i.tolist())}
        default = int(ctx.attr("default_int64", -1))
        out = np.asarray([table.get(str(s), default) for s in xv.reshape(-1)], np.int64)
    else:
        table = {i: s for i, s in zip(cats_i.tolist(), cats_s)}
        default = str(ctx.attr("default_string", "_Unused"))
        out = np.asarray([table.get(int(v), default) for v in xv.reshape(-1)], dtype=object)
    return [out.reshape(xv.shape)]


# ---------------------------------------------------------------------------
# map-typed ops (host dicts in the interpreter's environment)
# ---------------------------------------------------------------------------


@_ml_op("ZipMap")
def _zip_map(ctx, scores):
    """[N, C] scores -> a list of {label: score} dicts (the usual tail of a
    sklearn classifier export)."""
    labels_i = ctx.attr("classlabels_int64s")
    labels = ([int(v) for v in labels_i] if labels_i is not None
              else [str(s) for s in ctx.attr("classlabels_strings")])
    sv = np.asarray(_require_static(scores, "ZipMap", what="scores"))
    if sv.ndim == 1:
        sv = sv[None]
    if sv.shape[-1] != len(labels):
        raise ValueError(
            f"ZipMap got {sv.shape[-1]} score columns for {len(labels)} labels"
        )
    return [[dict(zip(labels, row.astype(np.float32).tolist())) for row in sv]]


@_ml_op("DictVectorizer")
def _dict_vectorizer(ctx, m):
    vocab_s = ctx.attr("string_vocabulary")
    vocab = ([str(s) for s in vocab_s] if vocab_s is not None
             else [int(v) for v in ctx.attr("int64_vocabulary")])
    m = _require_static(m, "DictVectorizer", what="map input")
    maps = m if isinstance(m, list) else [m]
    if not all(isinstance(d, dict) for d in maps):
        raise ValueError("DictVectorizer input must be a map or seq of maps")
    out = np.asarray([[float(d.get(k, 0.0)) for k in vocab] for d in maps], np.float32)
    return [out if isinstance(m, list) else out[0]]


@_ml_op("CastMap")
def _cast_map(ctx, m):
    cast_to = str(ctx.attr("cast_to", "TO_FLOAT"))
    map_form = str(ctx.attr("map_form", "DENSE"))
    max_map = int(ctx.attr("max_map", 1))
    m = _require_static(m, "CastMap", what="map input")
    maps = m if isinstance(m, list) else [m]
    rows = []
    for d in maps:
        if not isinstance(d, dict):
            raise ValueError("CastMap input must be a map or seq of maps")
        if map_form == "DENSE":
            vals = [d[k] for k in sorted(d)]
        else:
            vals = [0] * max_map
            for k, v in d.items():
                if 0 <= int(k) < max_map:
                    vals[int(k)] = v
        rows.append(vals)
    width = max((len(r) for r in rows), default=0)
    rows = [r + [0] * (width - len(r)) for r in rows]
    if cast_to == "TO_STRING":
        out = np.asarray([[str(v) for v in r] for r in rows], dtype=object)
    elif cast_to == "TO_INT64":
        out = np.asarray(rows, dtype=np.int64)
    else:
        out = np.asarray(rows, dtype=np.float32)
    return [out if isinstance(m, list) else out[0]]


# ---------------------------------------------------------------------------
# linear models
# ---------------------------------------------------------------------------


def _as_2d_f32(ctx, x) -> torch.Tensor:
    x = _f32(ctx, x)
    return x[None] if x.ndim == 1 else x


def _affine(ctx, x2, w: np.ndarray, bias) -> torch.Tensor:
    """x2 @ w.T (+ bias), with the host weights on x2's device once."""
    y = x2 @ _tensor(ctx, np.ascontiguousarray(w.T), x2.device)
    if bias is not None:
        y = y + _tensor(ctx, np.asarray(list(bias), np.float32), x2.device)
    return y


@_ml_op("LinearRegressor", fold=True)
def _linear_regressor(ctx, x):
    targets = int(ctx.attr("targets", 1))
    coef = np.asarray(list(ctx.attr("coefficients")), np.float32)
    x2 = _as_2d_f32(ctx, x)
    y = _affine(ctx, x2, coef.reshape(targets, x2.shape[-1]), ctx.attr("intercepts"))
    return [_post_transform(y, str(ctx.attr("post_transform", "NONE")))]


@_ml_op("LinearClassifier", fold=True)
def _linear_classifier(ctx, x):
    labels, is_string = _class_labels(ctx)
    coef = np.asarray(list(ctx.attr("coefficients")), np.float32)
    post = str(ctx.attr("post_transform", "NONE"))
    x2 = _as_2d_f32(ctx, x)
    f = x2.shape[-1]
    if coef.size % f:
        raise ValueError(
            f"LinearClassifier has {coef.size} coefficients, not a multiple "
            f"of the feature count {f}"
        )
    w = coef.reshape(-1, f)
    scores = _affine(ctx, x2, w, ctx.attr("intercepts"))
    if w.shape[0] == 1 and len(labels) == 2:
        # Binary single-score convention (ORT): pair the margin as (-s, s)
        # FIRST, then post-transform the pair (LOGISTIC gives (1-p, p), and
        # SOFTMAX stays a real 2-way softmax).
        scores = torch.cat([-scores, scores], dim=-1)
    scores = _post_transform(scores, post)
    return [_pick_labels(ctx, scores, labels, is_string, "LinearClassifier"), scores]


# ---------------------------------------------------------------------------
# tree ensembles
# ---------------------------------------------------------------------------
#
# The forest is flattened on the host into dense node tables (feature id,
# threshold, branch mode, children per global node); evaluation is a
# fixed-depth loop of gathers over a [rows, trees] cursor, with no
# data-dependent control flow. Leaf payouts are a [rows, entries] equality
# mask added into the per-tree class or target columns.

_TREE_MODES = {
    "LEAF": 0, "BRANCH_LEQ": 1, "BRANCH_LT": 2, "BRANCH_GTE": 3,
    "BRANCH_GT": 4, "BRANCH_EQ": 5, "BRANCH_NEQ": 6,
}


def _build_tree_tables(ctx, op_name):
    tree_ids = [int(v) for v in ctx.attr("nodes_treeids")]
    node_ids = [int(v) for v in ctx.attr("nodes_nodeids")]
    feats = np.asarray([int(v) for v in ctx.attr("nodes_featureids")], np.int32)
    values = np.asarray([float(v) for v in ctx.attr("nodes_values")], np.float32)
    modes = [str(m) for m in ctx.attr("nodes_modes")]
    true_ids = [int(v) for v in ctx.attr("nodes_truenodeids")]
    false_ids = [int(v) for v in ctx.attr("nodes_falsenodeids")]
    miss = ctx.attr("nodes_missing_value_tracks_true")
    miss = (np.asarray([int(v) for v in miss], np.int32) if miss is not None
            else np.zeros(len(tree_ids), np.int32))
    n = len(tree_ids)
    if not (len(node_ids) == len(feats) == len(values) == len(modes)
            == len(true_ids) == len(false_ids) == miss.size == n):
        raise ValueError(f"{op_name}: nodes_* attribute lengths disagree")
    try:
        mode_codes = np.asarray([_TREE_MODES[m] for m in modes], np.int32)
    except KeyError as e:
        raise ValueError(f"{op_name}: unknown node mode {e.args[0]!r}") from None

    index = {}
    for g, (t, nid) in enumerate(zip(tree_ids, node_ids)):
        if (t, nid) in index:
            raise ValueError(f"{op_name}: duplicate node ({t}, {nid})")
        index[(t, nid)] = g
    trees = sorted(set(tree_ids))
    tree_pos = {t: i for i, t in enumerate(trees)}

    is_leaf = mode_codes == 0
    true_g = np.zeros(n, np.int32)
    false_g = np.zeros(n, np.int32)
    children = set()
    for g, (t, mode) in enumerate(zip(tree_ids, mode_codes)):
        if mode == 0:
            true_g[g] = false_g[g] = g  # leaves loop on themselves
            continue
        try:
            true_g[g] = index[(t, true_ids[g])]
            false_g[g] = index[(t, false_ids[g])]
        except KeyError:
            raise ValueError(
                f"{op_name}: node ({t}, {node_ids[g]}) references a child "
                f"that does not exist in tree {t}"
            ) from None
        children.add(true_g[g])
        children.add(false_g[g])

    # The root of each tree is its one node never referenced as a child.
    cands_per_tree = {t: [] for t in trees}
    for g, t in enumerate(tree_ids):
        if g not in children:
            cands_per_tree[t].append(g)
    roots = np.zeros(len(trees), np.int32)
    for t in trees:
        cands = cands_per_tree[t]
        if len(cands) != 1:
            # fall back to the conventional nodeid-0 root
            if (t, 0) not in index:
                raise ValueError(f"{op_name}: tree {t} has no identifiable root")
            cands = [index[(t, 0)]]
        roots[tree_pos[t]] = cands[0]

    # depth by BFS (cycle-checked): the number of descent steps needed.
    depth = 0
    seen_global = set()
    frontier = [(int(r), 0) for r in roots]
    while frontier:
        g, d = frontier.pop()
        if g in seen_global:
            raise ValueError(f"{op_name}: node cycle detected at global {g}")
        seen_global.add(g)
        depth = max(depth, d)
        if not is_leaf[g]:
            frontier.append((int(true_g[g]), d + 1))
            frontier.append((int(false_g[g]), d + 1))

    return dict(
        feats=feats, values=values, modes=mode_codes, true_g=true_g,
        false_g=false_g, miss=miss, roots=roots, depth=depth,
        tree_pos=tree_pos, is_leaf=is_leaf, index=index,
    )


def _tree_descend(ctx, x2, tables):
    """Every tree on every row: the final leaf cursor [N, T]."""
    # A branch node's feature id must address a real input column (the
    # gather would read out of range where ORT errors); the feature count
    # is static, so check it on the host.
    feats_np = np.asarray(tables["feats"])
    branch = np.asarray(tables["modes"]) != 0
    if branch.any():
        bf = feats_np[branch]
        if bf.min() < 0 or bf.max() >= x2.shape[-1]:
            bad = int(bf.min()) if bf.min() < 0 else int(bf.max())
            raise ValueError(
                f"tree ensemble references feature {bad} but the input "
                f"has only {x2.shape[-1]} features"
            )
    dev = x2.device

    def table(name, dtype):
        return _tensor(ctx, np.asarray(tables[name]).astype(dtype), dev)

    feats = table("feats", np.int64).clamp(0, max(x2.shape[-1] - 1, 0))
    thresh = table("values", np.float32)
    modes = table("modes", np.int64)
    true_g = table("true_g", np.int64)
    false_g = table("false_g", np.int64)
    miss = table("miss", np.int64)
    members = tables.get("members")
    members = None if members is None else _tensor(ctx, members, dev)
    n = x2.shape[0]
    roots = table("roots", np.int64)
    cur = roots[None, :].expand(n, roots.shape[0])
    rows = torch.arange(n, device=dev)[:, None]
    for _ in range(tables["depth"]):
        v = x2[rows, feats[cur]]
        th = thresh[cur]
        m = modes[cur]
        cond = torch.ones_like(v, dtype=torch.bool)
        for code, c in ((6, v != th), (5, v == th), (4, v > th), (3, v >= th),
                        (2, v < th), (1, v <= th)):
            cond = torch.where(m == code, c, cond)
        if members is not None:  # mode 7: BRANCH_MEMBER (TreeEnsemble v5)
            in_set = (v[..., None] == members[cur]).any(dim=-1)
            cond = torch.where(m == 7, in_set, cond)
        cond = torch.where(torch.isnan(v), miss[cur] > 0, cond)
        nxt = torch.where(cond, true_g[cur], false_g[cur])
        cur = torch.where(m == 0, cur, nxt)
    return cur


def _leaf_payout(ctx, cur, tables, prefix, op_name, n_cols):
    """Leaf weights added into per-tree columns, [N, T * n_cols] (callers
    reduce over trees)."""
    e_tree = [int(v) for v in ctx.attr(f"{prefix}_treeids")]
    e_node = [int(v) for v in ctx.attr(f"{prefix}_nodeids")]
    e_col = np.asarray([int(v) for v in ctx.attr(f"{prefix}_ids")], np.int64)
    e_w = np.asarray([float(v) for v in ctx.attr(f"{prefix}_weights")], np.float32)
    tree_pos = tables["tree_pos"]
    node_index = tables["index"]
    try:
        e_glob = np.asarray([node_index[(t, nid)] for t, nid in zip(e_tree, e_node)],
                            np.int64)
        e_tpos = np.asarray([tree_pos[t] for t in e_tree], np.int64)
    except KeyError as e:
        raise ValueError(
            f"{op_name}: {prefix} entry references unknown node {e.args[0]}"
        ) from None
    if e_col.size and (e_col.min() < 0 or e_col.max() >= n_cols):
        bad = int(e_col.min()) if e_col.min() < 0 else int(e_col.max())
        raise ValueError(
            f"{op_name}: {prefix}_ids entry {bad} outside [0, {n_cols})"
        )
    return _entry_payout(ctx, cur, e_tpos, e_glob, e_w, e_tpos * n_cols + e_col,
                         len(tree_pos) * n_cols), e_w


def _entry_payout(ctx, cur, e_tpos, e_glob, e_w, flat_cols, width):
    dev = cur.device
    hits = cur[:, _tensor(ctx, e_tpos, dev)] == _tensor(ctx, e_glob, dev)
    contrib = hits.float() * _tensor(ctx, e_w, dev)
    out = torch.zeros((cur.shape[0], width), dtype=torch.float32, device=dev)
    return out.index_add(1, _tensor(ctx, np.asarray(flat_cols, np.int64), dev), contrib)


def _aggregate(per_tree, agg, n_trees):
    if agg == "SUM":
        return per_tree.sum(dim=1)
    if agg == "AVERAGE":
        return per_tree.sum(dim=1) / n_trees
    if agg == "MIN":
        return per_tree.amin(dim=1)
    if agg == "MAX":
        return per_tree.amax(dim=1)
    raise ValueError(f"invalid aggregate_function {agg!r}")


@_ml_op("TreeEnsembleRegressor", fold=True)
def _tree_ensemble_regressor(ctx, x):
    tables = _build_tree_tables(ctx, "TreeEnsembleRegressor")
    n_targets = int(ctx.attr("n_targets", 1))
    agg = str(ctx.attr("aggregate_function", "SUM"))
    x2 = _as_2d_f32(ctx, x)
    cur = _tree_descend(ctx, x2, tables)
    per_tree, _ = _leaf_payout(ctx, cur, tables, "target", "TreeEnsembleRegressor",
                               n_targets)
    t = len(tables["tree_pos"])
    y = _aggregate(per_tree.reshape(x2.shape[0], t, n_targets), agg, t)
    base = ctx.attr("base_values")
    if base is not None:
        y = y + _tensor(ctx, np.asarray(list(base), np.float32), y.device)
    return [_post_transform(y, str(ctx.attr("post_transform", "NONE")))]


@_ml_op("TreeEnsembleClassifier", fold=True)
def _tree_ensemble_classifier(ctx, x):
    labels, is_string = _class_labels(ctx)
    tables = _build_tree_tables(ctx, "TreeEnsembleClassifier")
    post = str(ctx.attr("post_transform", "NONE"))
    class_ids = [int(v) for v in ctx.attr("class_ids")]
    # A class pruned from every tree still owns a (zero) score column,
    # except in the binary single-score convention, where one column fans
    # out to two below (ORT sizes by class count the same way).
    n_cols = max(class_ids) + 1
    if len(labels) > 2:
        n_cols = max(n_cols, len(labels))
    x2 = _as_2d_f32(ctx, x)
    cur = _tree_descend(ctx, x2, tables)
    per_tree, e_w = _leaf_payout(ctx, cur, tables, "class", "TreeEnsembleClassifier",
                                 n_cols)
    t = len(tables["tree_pos"])
    scores = per_tree.reshape(x2.shape[0], t, n_cols).sum(dim=1)
    base = ctx.attr("base_values")
    if base is not None:
        scores = scores + _tensor(ctx, np.asarray(list(base), np.float32), scores.device)
    if n_cols == 1 and len(labels) == 2:
        # Single-score binary convention (ORT write_scores): all-positive
        # leaf weights make the score a vote, paired as (1-s, s); mixed
        # signs make it a margin, paired as (-s, s). The pair comes FIRST
        # and the post-transform applies to it.
        if bool(np.all(e_w >= 0)):
            scores = torch.cat([1.0 - scores, scores], dim=-1)
        else:
            scores = torch.cat([-scores, scores], dim=-1)
    scores = _post_transform(scores, post)
    return [_pick_labels(ctx, scores, labels, is_string, "TreeEnsembleClassifier"),
            scores]


# ---------------------------------------------------------------------------
# support-vector machines
# ---------------------------------------------------------------------------


def _svm_kernel(ctx, x2, sv: np.ndarray):
    """K(x, sv): the [N, SV] kernel matrix. kernel_params = [gamma, coef0,
    degree] (the libsvm layout, ORT's defaults)."""
    kind = str(ctx.attr("kernel_type", "LINEAR"))
    params = ctx.attr("kernel_params")
    gamma, coef0, degree = (
        [float(v) for v in params] + [0.0, 0.0, 0.0]
    )[:3] if params else (0.0, 0.0, 0.0)
    dots = x2 @ _tensor(ctx, np.ascontiguousarray(sv.T), x2.device)
    if kind == "LINEAR":
        return dots
    if kind == "POLY":
        return torch.pow(gamma * dots + coef0, degree)
    if kind == "SIGMOID":
        return torch.tanh(gamma * dots + coef0)
    if kind == "RBF":
        sv_sq = _tensor(ctx, np.sum(np.square(sv), axis=1)[None, :], x2.device)
        sq = torch.sum(torch.square(x2), dim=1, keepdim=True) - 2.0 * dots + sv_sq
        return torch.exp(-gamma * sq)
    raise ValueError(f"invalid kernel_type {kind!r}")


@_ml_op("SVMRegressor", fold=True)
def _svm_regressor(ctx, x):
    coef = np.asarray(list(ctx.attr("coefficients")), np.float32)
    rho = np.asarray(list(ctx.attr("rho", [0.0])), np.float32)
    n_sv = int(ctx.attr("n_supports", 0))
    x2 = _as_2d_f32(ctx, x)
    f = x2.shape[-1]
    if n_sv > 0:
        sv = np.asarray(list(ctx.attr("support_vectors")), np.float32).reshape(n_sv, f)
        k = _svm_kernel(ctx, x2, sv)
        y = k @ _tensor(ctx, coef[:n_sv, None], x2.device) + float(rho[0])
    else:
        y = x2 @ _tensor(ctx, coef.reshape(f, 1), x2.device) + float(rho[0])
    if int(ctx.attr("one_class", 0)):
        y = torch.where(y > 0, torch.ones_like(y), -torch.ones_like(y))
    return [_post_transform(y, str(ctx.attr("post_transform", "NONE")))]


def _platt_pairwise_probs(dec, prob_a, prob_b):
    """Per-pair Platt probability of the pair's FIRST class: libsvm's
    ``sigmoid_predict`` (ORT's ``sigmoid_probability``),
    ``sigmoid(-(A*d + B))`` clamped to [1e-7, 1 - 1e-7]."""
    r = torch.sigmoid(-(dec * prob_a + prob_b))
    return torch.clamp(r, 1e-7, 1.0 - 1e-7)


def _wu_lin_weng_couple(ctx, r_flat, pairs, c):
    """One-vs-one pairwise probabilities coupled into class probabilities:
    Wu, Lin & Weng (JMLR 2004) method 2, libsvm's
    ``multiclass_probability``. Q from the pairwise matrix, then the
    normalized fixed-point update, ``max(100, k)`` iterations; a row whose
    ``max_t |Qp_t - pQp|`` fell below ``0.005/k`` is frozen (its step is
    0), which is libsvm's early exit per sample."""
    n = r_flat.shape[0]
    dev = r_flat.device
    i_idx = _tensor(ctx, np.asarray([i for i, _ in pairs], np.int64), dev)
    j_idx = _tensor(ctx, np.asarray([j for _, j in pairs], np.int64), dev)
    big_r = torch.zeros((n, c, c), dtype=torch.float32, device=dev)
    big_r[:, i_idx, j_idx] = r_flat
    big_r[:, j_idx, i_idx] = 1.0 - r_flat
    # Q[t,j] = -r[j,t] * r[t,j] off the diagonal; Q[t,t] = sum_j r[j,t]^2
    q = -(big_r.transpose(1, 2) * big_r)
    q_diag = torch.sum(torch.square(big_r), dim=1)
    ti = torch.arange(c, device=dev)
    q[:, ti, ti] = q_diag
    eps = 0.005 / c
    p = torch.full((n, c), 1.0 / c, dtype=torch.float32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(max(100, c)):
        qp = torch.einsum("ntj,nj->nt", q, p)
        pqp = torch.sum(p * qp, dim=1)
        done = done | (torch.amax(torch.abs(qp - pqp[:, None]), dim=1) < eps)
        for t in range(c):  # the sequential in-place sweep
            diff = torch.where(done, zero, (pqp - qp[:, t]) / q_diag[:, t])
            p = p.index_add(1, ti[t:t + 1], diff[:, None])
            pqp = (pqp + diff * (diff * q_diag[:, t] + 2.0 * qp[:, t])) \
                / torch.square(1.0 + diff)
            qp = (qp + diff[:, None] * q[:, t, :]) / (1.0 + diff)[:, None]
            p = p / (1.0 + diff)[:, None]
    return p


def _ovo_matrices(counts, dual, c):
    """The one-vs-one decision as one product: [SV, pairs] where pair
    (i, j) takes ``dual[j-1]`` over class i's vectors and ``dual[i]`` over
    class j's, and the pairs in order."""
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(int)
    pairs = [(i, j) for i in range(c) for j in range(i + 1, c)]
    m = np.zeros((int(starts[-1]), len(pairs)), np.float32)
    for p, (i, j) in enumerate(pairs):
        m[starts[i]:starts[i + 1], p] = dual[j - 1, starts[i]:starts[i + 1]]
        m[starts[j]:starts[j + 1], p] = dual[i, starts[j]:starts[j + 1]]
    return m, pairs


@_ml_op("SVMClassifier", fold=True)
def _svm_classifier(ctx, x):
    """libsvm's one-vs-one SVC (decision values and votes) and the linear
    mode; with Platt tables (prob_a/prob_b) the scores are the
    Wu-Lin-Weng coupled class probabilities and the label their argmax
    (libsvm's ``svm_predict_probability``). Pair (i, j)'s decision is
    ``sum_{v in SV_i} coef[j-1, v] K(x, v) + sum_{v in SV_j} coef[i, v]
    K(x, v) + rho[pair]``; a vote for i when it is positive. The file is
    in libsvm's orientation (tests/test_sklearn_oracle.py)."""
    labels, is_string = _class_labels(ctx)
    c = len(labels)
    coef = np.asarray(list(ctx.attr("coefficients")), np.float32)
    rho = np.asarray(list(ctx.attr("rho", [0.0])), np.float32)
    post = str(ctx.attr("post_transform", "NONE"))
    vpc = ctx.attr("vectors_per_class")
    sv_flat = ctx.attr("support_vectors")
    x2 = _as_2d_f32(ctx, x)
    dev = x2.device
    f = x2.shape[-1]

    if not sv_flat:
        # linear mode: one coefficient row per class (a binary export may
        # carry one row, expanded as LinearClassifier expands it).
        if coef.size % f:
            raise ValueError(
                f"SVMClassifier has {coef.size} coefficients, not a "
                f"multiple of the feature count {f}"
            )
        w = coef.reshape(-1, f)
        scores = _affine(ctx, x2, w, None) + float(rho[0])
        if w.shape[0] == 1 and c == 2:
            scores = torch.cat([-scores, scores], dim=-1)
        scores = _post_transform(scores, post)
        return [_pick_labels(ctx, scores, labels, is_string, "SVMClassifier"), scores]

    counts = [int(v) for v in vpc]
    if len(counts) != c:
        raise ValueError(
            f"SVMClassifier has {len(counts)} vectors_per_class entries for {c} classes"
        )
    total_sv = sum(counts)
    n_pairs = c * (c - 1) // 2
    if len(rho) < n_pairs:
        raise ValueError(
            f"SVMClassifier has {len(rho)} rho entries; {c} classes form "
            f"{n_pairs} one-vs-one pairs"
        )
    if coef.size != (c - 1) * total_sv:
        raise ValueError(
            f"SVMClassifier has {coef.size} coefficients, expected "
            f"(n_classes-1)*total_sv = {(c - 1) * total_sv}"
        )
    sv = np.asarray(list(sv_flat), np.float32).reshape(total_sv, f)
    m, pairs = _ovo_matrices(counts, coef.reshape(c - 1, total_sv), c)
    k = _svm_kernel(ctx, x2, sv)
    dec = k @ _tensor(ctx, m, dev) + _tensor(ctx, rho[:n_pairs], dev)  # [N, pairs]

    prob_a, prob_b = ctx.attr("prob_a"), ctx.attr("prob_b")
    if (prob_a is None) != (prob_b is None):
        raise ValueError(
            "SVMClassifier carries only one of prob_a/prob_b; Platt "
            "coupling needs both tables"
        )
    if prob_a is not None:
        pa = np.asarray(list(prob_a), np.float32)
        pb = np.asarray(list(prob_b), np.float32)
        if len(pa) < len(pairs) or len(pb) < len(pairs):
            raise ValueError(
                f"SVMClassifier prob_a/prob_b hold {len(pa)}/{len(pb)} "
                f"entries; {c} classes form {len(pairs)} one-vs-one pairs"
            )
        r = _platt_pairwise_probs(dec, _tensor(ctx, pa[:len(pairs)], dev),
                                  _tensor(ctx, pb[:len(pairs)], dev))
        probs = _wu_lin_weng_couple(ctx, r, pairs, c)
        # The label is the argmax of the coupled probabilities (first max
        # on ties), not the vote count.
        label_idx = torch.argmax(probs, dim=-1)
        scores = _post_transform(probs, post)
    else:
        win = (dec > 0).float()
        vote_i = np.zeros((len(pairs), c), np.float32)
        vote_j = np.zeros((len(pairs), c), np.float32)
        for p, (i, j) in enumerate(pairs):
            vote_i[p, i] = 1.0
            vote_j[p, j] = 1.0
        votes = win @ _tensor(ctx, vote_i, dev) + (1.0 - win) @ _tensor(ctx, vote_j, dev)
        label_idx = torch.argmax(votes, dim=-1)
        scores = torch.cat([-dec, dec], dim=-1) if c == 2 else dec
        scores = _post_transform(scores, post)
    if not ctx.wants_output(0):
        return [None, scores]
    return [_labels_of(ctx, label_idx, labels, is_string, "SVMClassifier"), scores]


_V5_POST = {0: "NONE", 1: "SOFTMAX", 2: "LOGISTIC", 3: "SOFTMAX_ZERO", 4: "PROBIT"}
_V5_AGG = {0: "AVERAGE", 1: "SUM", 2: "MIN", 3: "MAX"}


@_ml_op("TreeEnsemble", fold=True)
def _tree_ensemble_v5(ctx, x):
    """The unified TreeEnsemble (ai.onnx.ml opset 5): leaves in separate
    leaf_* arrays (nodes_*leafs say whether a child index is a leaf),
    tensor attributes with integer codes, and BRANCH_MEMBER set tests
    against the NaN-delimited ``membership_values``. Converted to the
    tables of the v1/v3 ensembles (leaves after the inner nodes) and run
    by the same descent."""
    feats = np.asarray([int(v) for v in ctx.attr("nodes_featureids")], np.int32)
    splits = ctx.attr("nodes_splits").to_numpy().astype(np.float32).reshape(-1)
    v5_modes = ctx.attr("nodes_modes").to_numpy().astype(np.int64).reshape(-1)
    true_ids = [int(v) for v in ctx.attr("nodes_truenodeids")]
    false_ids = [int(v) for v in ctx.attr("nodes_falsenodeids")]
    true_leafs = [int(v) for v in ctx.attr("nodes_trueleafs")]
    false_leafs = [int(v) for v in ctx.attr("nodes_falseleafs")]
    leaf_tids = np.asarray([int(v) for v in ctx.attr("leaf_targetids")], np.int64)
    leaf_w = ctx.attr("leaf_weights").to_numpy().astype(np.float32).reshape(-1)
    roots = [int(v) for v in ctx.attr("tree_roots")]
    n_targets = int(ctx.attr("n_targets", 1))
    agg = _V5_AGG.get(int(ctx.attr("aggregate_function", 1)))
    post = _V5_POST.get(int(ctx.attr("post_transform", 0)))
    if agg is None or post is None:
        raise ValueError("TreeEnsemble: invalid aggregate_function/post_transform code")
    n_int, n_leaf = len(feats), len(leaf_w)
    if not (len(splits) == len(v5_modes) == len(true_ids) == len(false_ids)
            == len(true_leafs) == len(false_leafs) == n_int):
        raise ValueError("TreeEnsemble: nodes_* attribute lengths disagree")
    if len(leaf_tids) != n_leaf:
        raise ValueError("TreeEnsemble: leaf_* attribute lengths disagree")
    if n_leaf and (leaf_tids.min() < 0 or leaf_tids.max() >= n_targets):
        raise ValueError(f"TreeEnsemble: leaf_targetids outside [0, {n_targets})")
    if np.any(v5_modes < 0) or np.any(v5_modes > 6):
        raise ValueError("TreeEnsemble: unknown node mode code")

    total = n_int + n_leaf
    modes = np.zeros(total, np.int32)  # appended leaves keep code 0 (LEAF)
    modes[:n_int] = np.where(v5_modes == 6, 7, v5_modes + 1)
    feat_all = np.concatenate([feats, np.zeros(n_leaf, np.int32)])
    thresh_all = np.concatenate([splits, np.zeros(n_leaf, np.float32)])
    true_g = np.arange(total, dtype=np.int32)
    false_g = true_g.copy()
    for g in range(n_int):
        t_child = n_int + true_ids[g] if true_leafs[g] else true_ids[g]
        f_child = n_int + false_ids[g] if false_leafs[g] else false_ids[g]
        if not (0 <= t_child < total and 0 <= f_child < total) or (
            not true_leafs[g] and true_ids[g] >= n_int
        ) or (not false_leafs[g] and false_ids[g] >= n_int):
            raise ValueError(
                f"TreeEnsemble: node {g} references a child that does not exist"
            )
        true_g[g], false_g[g] = t_child, f_child
    miss = np.zeros(total, np.int32)
    miss_attr = ctx.attr("nodes_missing_value_tracks_true")
    if miss_attr is not None:
        miss[:n_int] = [int(v) for v in miss_attr]

    members = None
    member_nodes = [g for g in range(n_int) if modes[g] == 7]
    if member_nodes:
        mv = ctx.attr("membership_values")
        if mv is None:
            raise ValueError(
                "TreeEnsemble has BRANCH_MEMBER nodes but no membership_values"
            )
        vals = mv.to_numpy().astype(np.float32).reshape(-1)
        sets, curset = [], []
        for v in vals:
            if np.isnan(v):
                sets.append(curset)
                curset = []
            else:
                curset.append(float(v))
        if curset:
            sets.append(curset)
        if len(sets) != len(member_nodes):
            raise ValueError(
                f"TreeEnsemble: {len(member_nodes)} BRANCH_MEMBER nodes but "
                f"{len(sets)} NaN-delimited membership sets"
            )
        width = max(len(s) for s in sets)
        members = np.full((total, width), np.nan, np.float32)
        for g, s in zip(member_nodes, sets):
            members[g, :len(s)] = s

    # Payout entries ((tree, leaf) pairs) and the depth, cycle-checked. A
    # leaf may be shared (by both branches of a node, by several nodes, by
    # trees), so only an inner node reached twice in one tree's walk is a
    # cycle; a leaf reached twice is one payout entry.
    depth = 0
    entries = []  # (tree_pos, global_leaf)
    for t, r in enumerate(roots):
        if not 0 <= r < n_int:
            raise ValueError(f"TreeEnsemble: tree root {r} is not an inner node")
        seen_inner = set()
        seen_leaves = set()
        stack = [(r, 0)]
        while stack:
            g, d = stack.pop()
            depth = max(depth, d)
            if modes[g] == 0:
                seen_leaves.add(g)
                continue
            if g in seen_inner:
                raise ValueError(
                    f"TreeEnsemble: inner node {g} is reached twice in tree {t} (cycle)"
                )
            seen_inner.add(g)
            stack.append((int(true_g[g]), d + 1))
            stack.append((int(false_g[g]), d + 1))
        entries.extend((t, g) for g in sorted(seen_leaves))

    tables = dict(
        feats=feat_all, values=thresh_all, modes=modes, true_g=true_g,
        false_g=false_g, miss=miss, roots=np.asarray(roots, np.int32),
        depth=depth, members=members,
    )
    x2 = _as_2d_f32(ctx, x)
    cur = _tree_descend(ctx, x2, tables)
    n_trees = len(roots)
    e_tpos = np.asarray([t for t, _ in entries], np.int64)
    e_glob = np.asarray([g for _, g in entries], np.int64)
    e_leaf = e_glob - n_int  # index into the leaf arrays
    per_tree = _entry_payout(ctx, cur, e_tpos, e_glob, leaf_w[e_leaf],
                             e_tpos * n_targets + leaf_tids[e_leaf], n_trees * n_targets)
    y = _aggregate(per_tree.reshape(x2.shape[0], n_trees, n_targets), agg, n_trees)
    return [_post_transform(y, post)]
