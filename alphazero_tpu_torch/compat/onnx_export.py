"""Dependency-free ONNX export of the Splendor nets: the port's own copy
of ``alphazero_tpu/compat/onnx_export.py``.

The reference ships an ORT-consumable ``.onnx`` artifact
(``chkpt_to_onnx.py:20-41``: inputs ``board``/``valid_actions``, outputs
``pi``/``v``/``scdiffs``, dynamic batch axis) produced via torch.onnx.  That
route needs the ``onnx`` and ``onnxscript`` packages, which the port does
not depend on, so this module writes the standard ONNX protobuf **wire
format directly** (an emitter over the stable subset of ``onnx.proto3``)
and builds the inference graph (opset 13) for ``nn_version`` 0/1/2 from
the Flax-layout parameter trees that ``models.splendor_net.to_flax`` gives
(``export_net`` takes a port net).  For the same weights its bytes are the
JAX writer's.  Inference-mode only: dropout is identity,
BatchNormalization consumes the running statistics.

Validation lives in ``tests/test_torch_port_export.py``: the bytes against
the JAX writer's, and ``tests/onnx_mini.py``'s independent reader and
numpy interpreter against the port's forward.
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------- wire format
# field tag = (field_number << 3) | wire_type; wire types used here:
# 0 = varint, 2 = length-delimited (strings, sub-messages, packed repeated),
# 5 = 32-bit (float attribute values)


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _fv(field: int, n: int) -> bytes:
    return _varint((field << 3) | 0) + _varint(n)


def _fb(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _fs(field: int, s: str) -> bytes:
    return _fb(field, s.encode())


def _ff(field: int, x: float) -> bytes:
    return _varint((field << 3) | 5) + struct.pack("<f", x)


def _packed_ints(field: int, vals) -> bytes:
    return _fb(field, b"".join(_varint(v) for v in vals))


# ONNX TensorProto.DataType
F32, I64, BOOL = 1, 7, 9
_NP2ONNX = {np.dtype(np.float32): F32, np.dtype(np.int64): I64,
            np.dtype(np.bool_): BOOL}


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    return (_packed_ints(1, arr.shape)                  # dims
            + _fv(2, _NP2ONNX[arr.dtype])               # data_type
            + _fs(8, name)                              # name
            + _fb(9, arr.tobytes()))                    # raw_data


# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_INTS = 1, 2, 7


def _attr(name: str, value) -> bytes:
    body = _fs(1, name)
    if isinstance(value, float):
        body += _ff(2, value) + _fv(20, _AT_FLOAT)
    elif isinstance(value, int):
        body += _fv(3, value) + _fv(20, _AT_INT)
    elif isinstance(value, (list, tuple)):
        body += _packed_ints(8, value) + _fv(20, _AT_INTS)
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return body


def _node(op: str, inputs, outputs, **attrs) -> bytes:
    body = b"".join(_fs(1, i) for i in inputs)
    body += b"".join(_fs(2, o) for o in outputs)
    body += _fs(4, op)
    body += b"".join(_fb(5, _attr(k, v)) for k, v in attrs.items())
    return body


def _value_info(name: str, elem_type: int, dims) -> bytes:
    shape = b"".join(
        _fb(1, _fs(3, d) if isinstance(d, str) else _fv(1, d)) for d in dims)
    tensor_type = _fv(1, elem_type) + _fb(2, shape)
    return _fs(1, name) + _fb(2, _fb(1, tensor_type))


def _model(nodes, inputs, outputs, initializers, opset: int = 13) -> bytes:
    graph = b"".join(_fb(1, n) for n in nodes)
    graph += _fs(2, "splendor_net")
    graph += b"".join(_fb(5, t) for t in initializers)
    graph += b"".join(_fb(11, v) for v in inputs)
    graph += b"".join(_fb(12, v) for v in outputs)
    return (_fv(1, 8)                                   # ir_version
            + _fs(2, "alphazero_tpu")                   # producer_name
            + _fb(7, graph)
            + _fb(8, _fs(1, "") + _fv(2, opset)))       # opset_import


# ------------------------------------------------------------- graph builder
class _Graph:
    def __init__(self):
        self.nodes, self.inits, self._n = [], [], 0

    def name(self, hint="t"):
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, arr, hint="w"):
        nm = self.name(hint)
        self.inits.append(_tensor(nm, np.asarray(arr)))
        return nm

    def op(self, op_type, inputs, hint=None, n_out=1, **attrs):
        outs = [self.name(hint or op_type.lower()) for _ in range(n_out)]
        self.nodes.append(_node(op_type, inputs, outs, **attrs))
        return outs[0] if n_out == 1 else outs

    # ---- composite layers (inference mode) ----
    def dense(self, x, p):
        k = self.init(np.asarray(p["kernel"], np.float32), "kernel")
        b = self.init(np.asarray(p["bias"], np.float32), "bias")
        return self.op("Add", [self.op("MatMul", [x, k]), b])

    def bn(self, x, p, stats, eps=1e-5):
        """ONNX BatchNormalization normalizes axis 1, as the net's
        BatchNorms do on (B, C, L) tensors."""
        ins = [x,
               self.init(np.asarray(p["scale"], np.float32), "bn_scale"),
               self.init(np.asarray(p["bias"], np.float32), "bn_bias"),
               self.init(np.asarray(stats["mean"], np.float32), "bn_mean"),
               self.init(np.asarray(stats["var"], np.float32), "bn_var")]
        return self.op("BatchNormalization", ins, epsilon=float(eps))

    def slice(self, x, start, end, axis):
        return self.op("Slice", [
            x, self.init(np.array([start], np.int64), "starts"),
            self.init(np.array([end], np.int64), "ends"),
            self.init(np.array([axis], np.int64), "axes")])

    def reshape(self, x, shape):
        return self.op("Reshape",
                       [x, self.init(np.array(shape, np.int64), "shape")])

    def dpgpool(self, x, p, bs, channels, groups, items):
        """DenseAndPartialGPool (models/splendor_net.py): max+avg pool
        the first groups*items features in groups, dense+BN+relu the rest."""
        pool_len = groups * items
        g = self.reshape(self.slice(x, 0, pool_len, 2),
                         [0, channels, groups, items])
        maxp = self.op("ReduceMax", [g], axes=[3], keepdims=0)
        avgp = self.op("ReduceMean", [g], axes=[3], keepdims=0)
        d = self.dense(self.slice(x, pool_len, (1 << 31) - 1, 2), p["Dense_0"])
        d = self.op("Relu", [self.bn(d, p["BatchNorm_0"], bs["BatchNorm_0"])])
        return self.op("Concat", [maxp, avgp, d], axis=2)

    def flatten_gpool(self, x, length_to_pool, nb_channels):
        """_flatten_and_partial_gpool (models/splendor_net.py)."""
        xb = self.slice(x, 0, length_to_pool, 2)
        xe = self.slice(x, length_to_pool, (1 << 31) - 1, 2)
        first = self.slice(xb, 0, nb_channels, 1)
        last = self.slice(xb, nb_channels, (1 << 31) - 1, 1)
        maxp = self.op("ReduceMax", [first], axes=[1], keepdims=0)
        avgp = self.op("ReduceMean", [first], axes=[1], keepdims=0)
        flat = self.op("Concat", [maxp, avgp, self.reshape(last, [0, -1]),
                                  self.reshape(xe, [0, -1])], axis=1)
        return self.reshape(flat, [0, 1, -1])


def export_onnx(net_cfg, params, batch_stats, path: str) -> str:
    """Build the opset-13 inference graph for ``net_cfg.nn_version`` and
    write it to ``path``.  I/O contract mirrors the reference export
    (chkpt_to_onnx.py:31-41): float32 ``board`` (batch, nb_vect, 7) + bool
    ``valid_actions`` (batch, A) -> ``pi`` (masked log-softmax), ``v``
    (tanh), ``scdiffs`` (log-softmax over (batch, num_scdiffs, 31))."""
    c = net_cfg
    if c.nn_version == 3:
        raise ValueError("nn_version 3 (the BT4 transformer) has no ONNX "
                         "graph: export versions 0, 1 and 2 only")
    g = _Graph()
    P, BS = params, batch_stats
    w = c.width if c.nn_version != 2 else max(c.width, 256)

    x = g.op("Transpose", ["board"], perm=[0, 2, 1])        # (B, 7, nb_vect)
    x = g.dense(x, P["Dense_0"])
    x = g.op("Relu", [g.bn(x, P["BatchNorm_0"], BS["BatchNorm_0"])])
    x = g.op("Relu", [g.dense(x, P["Dense_1"])])

    if c.nn_version in (0, 1):
        x = g.dpgpool(x, P["DenseAndPartialGPool_0"],
                      BS["DenseAndPartialGPool_0"], c.vect_dim, 4, 8)
        x = g.op("Relu", [g.dense(x, P["Dense_2"])])
        x = g.flatten_gpool(x, w // 2, 5)                    # (B, 1, F)
        x = g.op("Relu", [g.dense(x, P["Dense_3"])])
        x = g.dpgpool(x, P["DenseAndPartialGPool_1"],
                      BS["DenseAndPartialGPool_1"], 1, 4, 4)
        y = g.bn(g.dense(x, P["Dense_4"]), P["BatchNorm_1"], BS["BatchNorm_1"])
        x = g.op("Relu", [y])
        x = g.op("Relu", [g.dense(x, P["Dense_5"])])
        x = g.dpgpool(x, P["DenseAndPartialGPool_2"],
                      BS["DenseAndPartialGPool_2"], 1, 4, 4)
        x = g.reshape(x, [0, w])                             # x[:, 0, :]
        heads = ("Dense_6", "Dense_7", "Dense_8", "Dense_9",
                 "Dense_10", "Dense_11")
    elif c.nn_version == 2:
        x = g.dpgpool(x, P["DenseAndPartialGPool_0"],
                      BS["DenseAndPartialGPool_0"], c.vect_dim, 4, 8)
        x = g.flatten_gpool(x, w // 2, 5)
        x = g.reshape(x, [0, -1])                            # x[:, 0, :]
        x = g.op("Relu", [g.dense(x, P["Dense_2"])])
        for blk in range(2):                                 # residual blocks
            h = g.bn(x, P[f"BatchNorm_{1 + blk}"], BS[f"BatchNorm_{1 + blk}"])
            h = g.op("Relu", [h])
            h = g.op("Relu", [g.dense(h, P[f"Dense_{3 + 2 * blk}"])])
            h = g.dense(h, P[f"Dense_{4 + 2 * blk}"])
            x = g.op("Add", [x, h])
        heads = ("Dense_7", "Dense_8", "Dense_9", "Dense_10",
                 "Dense_11", "Dense_12")
    else:
        raise ValueError(f"unknown nn_version {c.nn_version}")

    pi = g.dense(g.dense(x, P[heads[0]]), P[heads[1]])
    low = g.init(np.full((1,), -1e8, np.float32), "low")
    pi = g.op("Where", ["valid_actions", pi, low])
    g.nodes.append(_node("LogSoftmax", [pi], ["pi"], axis=-1))
    v = g.dense(g.dense(x, P[heads[2]]), P[heads[3]])
    g.nodes.append(_node("Tanh", [v], ["v"]))
    sd = g.dense(g.dense(x, P[heads[4]]), P[heads[5]])
    sd = g.reshape(sd, [0, c.num_scdiffs, c.scdiff_size])
    g.nodes.append(_node("LogSoftmax", [sd], ["scdiffs"], axis=-1))

    B = "batch_size"
    model = _model(
        g.nodes,
        inputs=[_value_info("board", F32, [B, c.nb_vect, c.vect_dim]),
                _value_info("valid_actions", BOOL, [B, c.action_size])],
        outputs=[_value_info("pi", F32, [B, c.action_size]),
                 _value_info("v", F32, [B, c.num_players]),
                 _value_info("scdiffs", F32,
                             [B, c.num_scdiffs, c.scdiff_size])],
        initializers=g.inits)
    with open(path, "wb") as f:
        f.write(model)
    return path


def export_net(net, path: str) -> str:
    """``export_onnx`` of a port net (``SplendorNet`` / ``SplendorNetV2``):
    its config and its weights in the Flax layout."""
    from ..models import splendor_net as N
    params, batch_stats = N.to_flax(net.state_dict())
    return export_onnx(net.cfg, params, batch_stats, path)
