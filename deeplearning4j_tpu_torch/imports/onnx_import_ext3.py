"""ONNX importer breadth, part 3 — the recurrent family; the port of
``deeplearning4j_tpu/imports/onnx_import_ext3.py``.

Reference: samediff-import-onnx mapping rules (SURVEY.md §2.3) and
libnd4j ``generic/nn/recurrent/*.cpp``.  The ONNX LSTM/GRU/RNN sequence
operators plus OneHot and Shrink.  Where the reference scans each
direction with one ``lax.scan``, the port loops over time in Python, one
step of batched products per time step (autograd follows the loop; no
hand kernel is on this path), keeping the reference's gate-order
re-layout and ``linear_before_reset``.  The weights import as trainable
variables (``_WEIGHT_BEARING_OPS`` lists them), so imported RNNs
fine-tune.

Imported for side effects at the bottom of ``onnx_import.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import register_op
from deeplearning4j_tpu_torch.imports.onnx_import import _bdecode as _s
from deeplearning4j_tpu_torch.imports.onnx_import import _op


_DEFAULT_ACTS = {"LSTM": ["Sigmoid", "Tanh", "Tanh"],
                 "GRU": ["Sigmoid", "Tanh"],
                 "RNN": ["Tanh"]}


def _rnn_common(ctx, node, kind: str):
    """Shared validation + input marshalling for LSTM/GRU/RNN."""
    attrs = node.attrs
    if int(attrs.get("layout", 0)) != 0:
        raise ValueError(f"ONNX import: {kind} layout=1 (batch-major) is "
                         "unsupported (torch exports layout=0)")
    if attrs.get("clip") is not None:
        raise ValueError(f"ONNX import: {kind} clip is unsupported")
    direction = _s(attrs.get("direction"), "forward")
    if direction not in ("forward", "reverse", "bidirectional"):
        raise ValueError(f"ONNX import: {kind} direction={direction!r}?")
    nd = 2 if direction == "bidirectional" else 1
    acts = [_s(a) for a in (attrs.get("activations") or [])] or \
        _DEFAULT_ACTS[kind] * nd
    if kind == "RNN":
        if any(a not in ("Tanh", "Relu") for a in acts) or \
                len(set(acts)) != 1:
            raise ValueError(f"ONNX import: RNN activations={acts} "
                             "unsupported (uniform Tanh or Relu only)")
    elif acts != _DEFAULT_ACTS[kind] * nd:
        raise ValueError(f"ONNX import: {kind} activations={acts} "
                         "unsupported (defaults only)")
    if kind == "LSTM" and int(attrs.get("input_forget", 0)):
        raise ValueError("ONNX import: LSTM input_forget is unsupported")
    ins = list(node.inputs) + [""] * 8
    if kind == "LSTM":
        x_n, w_n, r_n, b_n, sl_n, h0_n, c0_n = ins[:7]
        if ins[7]:
            raise ValueError("ONNX import: LSTM peephole weights (P) are "
                             "unsupported")
    else:
        x_n, w_n, r_n, b_n, sl_n, h0_n = ins[:6]
        c0_n = ""
    if sl_n:
        raise ValueError(f"ONNX import: {kind} per-example sequence_lens "
                         "is unsupported (pad to a fixed length)")
    args = [ctx.get(x_n), ctx.get(w_n), ctx.get(r_n)]
    flags = {"has_b": bool(b_n), "has_h0": bool(h0_n),
             "has_c0": bool(c0_n)}
    for name_, flag in ((b_n, "has_b"), (h0_n, "has_h0"),
                        (c0_n, "has_c0")):
        if name_:
            args.append(ctx.get(name_))
    op_attrs = {"hidden": int(attrs["hidden_size"]),
                "direction": direction, **flags}
    if kind == "RNN":
        op_attrs["activation"] = acts[0]
    return args, op_attrs


def _emit_rnn(ctx, node, op_name, args, op_attrs, n_out):
    outs = ctx.sd._op(op_name, args, op_attrs, n_out=n_out)
    for name_, var in zip(node.outputs[1:], outs[1:]):
        if name_:
            ctx.vars[name_] = var
    return outs[0]


@_op("LSTM")
def _lstm(ctx, node):
    args, op_attrs = _rnn_common(ctx, node, "LSTM")
    return _emit_rnn(ctx, node, "onnx_lstm", args, op_attrs, 3)


@_op("GRU")
def _gru(ctx, node):
    args, op_attrs = _rnn_common(ctx, node, "GRU")
    op_attrs["linear_before_reset"] = \
        int(node.attrs.get("linear_before_reset", 0))
    return _emit_rnn(ctx, node, "onnx_gru", args, op_attrs, 2)


@_op("RNN")
def _rnn(ctx, node):
    args, op_attrs = _rnn_common(ctx, node, "RNN")
    return _emit_rnn(ctx, node, "onnx_rnn", args, op_attrs, 2)


def _unpack(args, has_b, has_h0, has_c0=False):
    it = iter(args)
    x, W, R = next(it), next(it), next(it)
    B = next(it) if has_b else None
    h0 = next(it) if has_h0 else None
    c0 = next(it) if has_c0 else None
    return x, W, R, B, h0, c0


def _dir_list(direction):
    if direction == "forward":
        return [False]
    if direction == "reverse":
        return [True]
    return [False, True]


def _scan_dirs(x, one_dir, direction):
    """Run each direction's loop and stack ONNX-layout outputs:
    Y (t, nd, b, h), finals each (nd, b, h)."""
    outs = [one_dir(d, rev)
            for d, rev in enumerate(_dir_list(direction))]
    Y = torch.stack([o[0] for o in outs], dim=1)
    finals = [torch.stack([o[k] for o in outs], dim=0)
              for k in range(1, len(outs[0]))]
    return [Y] + finals


def _scan(step, carry, x, reverse):
    """``lax.scan`` as a loop over time: ``step(carry, x[t]) -> (carry,
    y)``; the ys come back stacked in input order."""
    ys = [None] * x.shape[0]
    order = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in order:
        carry, ys[t] = step(carry, x[t])
    return carry, torch.stack(ys)


@register_op("onnx_lstm")
def _onnx_lstm_impl(hidden=1, direction="forward", has_b=False,
                    has_h0=False, has_c0=False, **_):
    h = int(hidden)

    def fn(*args):
        x, W, R, B, h0, c0 = _unpack(args, has_b, has_h0, has_c0)
        t, b, _i = x.shape

        def one_dir(d, reverse):
            def reorder(m):          # ONNX gate rows i,o,f,c -> i,f,c,o
                return torch.cat(
                    [m[:h], m[2 * h:3 * h], m[3 * h:], m[h:2 * h]], dim=0)
            Wd, Rd = reorder(W[d]), reorder(R[d])
            bz = reorder((B[d][:4 * h] + B[d][4 * h:])[:, None])[:, 0] \
                if B is not None else x.new_zeros((4 * h,))
            hi = h0[d] if h0 is not None else x.new_zeros((b, h))
            ci = c0[d] if c0 is not None else x.new_zeros((b, h))

            def step(carry, xt):
                hh, cc = carry
                z = xt @ Wd.T + hh @ Rd.T + bz
                i_, f_, g_, o_ = torch.split(z, h, dim=-1)
                c2 = torch.sigmoid(f_) * cc \
                    + torch.sigmoid(i_) * torch.tanh(g_)
                h2 = torch.sigmoid(o_) * torch.tanh(c2)
                return (h2, c2), h2
            (hT, cT), hs = _scan(step, (hi, ci), x, reverse)
            return hs, hT, cT
        return _scan_dirs(x, one_dir, direction)
    return fn


@register_op("onnx_gru")
def _onnx_gru_impl(hidden=1, direction="forward", has_b=False,
                   has_h0=False, linear_before_reset=0, **_):
    h = int(hidden)

    def fn(*args):
        x, W, R, B, h0, _c0 = _unpack(args, has_b, has_h0)
        t, b, _i = x.shape

        def one_dir(d, reverse):
            Wd, Rd = W[d], R[d]                  # (3h, in)/(3h, h), z r h
            wb = B[d][:3 * h] if B is not None else x.new_zeros((3 * h,))
            rb = B[d][3 * h:] if B is not None else x.new_zeros((3 * h,))
            hi = h0[d] if h0 is not None else x.new_zeros((b, h))

            def step(hh, xt):
                gx = xt @ Wd.T + wb              # (b, 3h)
                gz, gr, gh = torch.split(gx, h, dim=-1)
                rz = hh @ Rd[:h].T + rb[:h]
                rr = hh @ Rd[h:2 * h].T + rb[h:2 * h]
                z = torch.sigmoid(gz + rz)
                r = torch.sigmoid(gr + rr)
                if linear_before_reset:          # torch convention
                    hc = torch.tanh(gh + r * (hh @ Rd[2 * h:].T
                                              + rb[2 * h:]))
                else:
                    hc = torch.tanh(gh + (r * hh) @ Rd[2 * h:].T
                                    + rb[2 * h:])
                h2 = z * hh + (1.0 - z) * hc
                return h2, h2
            hT, hs = _scan(step, hi, x, reverse)
            return hs, hT
        return _scan_dirs(x, one_dir, direction)
    return fn


@register_op("onnx_rnn")
def _onnx_rnn_impl(hidden=1, direction="forward", has_b=False,
                   has_h0=False, activation="Tanh", **_):
    h = int(hidden)
    act = torch.tanh if activation == "Tanh" else torch.relu

    def fn(*args):
        x, W, R, B, h0, _c0 = _unpack(args, has_b, has_h0)
        t, b, _i = x.shape

        def one_dir(d, reverse):
            bz = (B[d][:h] + B[d][h:]) if B is not None \
                else x.new_zeros((h,))
            hi = h0[d] if h0 is not None else x.new_zeros((b, h))

            def step(hh, xt):
                h2 = act(xt @ W[d].T + hh @ R[d].T + bz)
                return h2, h2
            hT, hs = _scan(step, hi, x, reverse)
            return hs, hT
        return _scan_dirs(x, one_dir, direction)
    return fn


# ---- misc round-5 additions ----------------------------------------------
@_op("OneHot")
def _onehot(ctx, node):
    depth = int(np.asarray(ctx.const_val(node.inputs[1])).reshape(-1)[0])
    values = np.asarray(ctx.const_val(node.inputs[2])).reshape(-1)
    return ctx.sd._op("onnx_onehot", [ctx.get(node.inputs[0])],
                      {"depth": depth,
                       "off": float(values[0]), "on": float(values[1]),
                       "axis": int(node.attrs.get("axis", -1))})


@register_op("onnx_onehot")
def _onnx_onehot_impl(depth=1, off=0.0, on=1.0, axis=-1, **_):
    def fn(idx):
        # spec: negatives in [-depth, -1] wrap; anything else out of range
        # yields an all-off row (a comparison against every class)
        i = idx.to(torch.int32)
        i = torch.where(i < 0, i + depth, i)
        oh = (i.unsqueeze(-1) == torch.arange(depth, device=i.device)
              ).to(torch.get_default_dtype())
        if axis != -1:
            oh = torch.movedim(oh, -1, int(axis) % oh.dim())
        return oh * (on - off) + off
    return fn


@_op("Shrink")
def _shrink(ctx, node):
    return ctx.sd._op("onnx_shrink", [ctx.get(node.inputs[0])],
                      {"lambd": float(node.attrs.get("lambd", 0.5)),
                       "bias": float(node.attrs.get("bias", 0.0))})


@register_op("onnx_shrink")
def _onnx_shrink_impl(lambd=0.5, bias=0.0, **_):
    def fn(x):
        return torch.where(x < -lambd, x + bias,
                           torch.where(x > lambd, x - bias,
                                       torch.zeros_like(x)))
    return fn
