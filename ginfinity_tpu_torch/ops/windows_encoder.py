"""The fused window encoder: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``ginfinity_tpu/ops/pallas_windows.py``.  Given a chunk of
windows in the aligned layout (slot ``i < L`` holds window position
``i``, slot ``L + i`` the pulled outside partner of position ``i``) and
their post-node-encoder activations ``x0 [C, 2L, h0]``, both compute
every GINE layer, the node norm, the pooling and the fc head, and
return ``[C, out_dim]``.

:func:`forward_windows_reference` is the plain version (the tensor code
of the JAX package's aligned XLA path, IEEE float32 sums).
:func:`forward_windows` runs the hand-written kernel
``csrc/windows_encoder.cu`` on a CUDA tensor and the plain version on a
CPU tensor; it never falls back from one to the other.  The kernel has
one route per ``GINConfig.matmul_precision``, as the TPU kernel has one
``precision`` per call:

* ``"highest"``: both products of every layer on the tensor cores as
  3xTF32 (the counterpart of ``Precision.HIGHEST``): each operand is
  split into a TF32 ``hi`` and ``lo`` and ``lo*hi' + hi*lo' + hi*hi'`` is
  summed in float32.  :func:`pack_params` stores the weights' parts for
  it (:func:`tile_weight`); the activations are split inside the kernel.
* ``"bf16"``: the counterpart of ``Precision.DEFAULT``, one bf16 pass
  with float32 sums.  Both operands of the two MLP products and of the fc
  head are rounded to bfloat16, and so is the in-window partner row
  ``x[j_local]``: the TPU kernel gathers it as a product with a one-hot
  matrix (``pallas_windows.py:132``), so at DEFAULT it reads
  ``bf16(x[j])``.  The kernel's route follows the TPU kernel it replaces
  there; the JAX package's XLA path, which serves the configs outside the
  kernel's gate, gathers exactly (``exact_gather=True`` here).
  :func:`pack_params` stores each weight rounded once to bf16
  (:func:`tile_weight_bf16`).  Every other step stays float32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ginfinity_tpu_torch.graphs.build import window_edge_const_rows
from ginfinity_tpu_torch.models.gine import GINConfig, _dense, apply_node_norm, bf16_round

_LAYER_META = 8  # per layer: w0, w1, b0, b1, eb, gn offsets; din; dout
_NORM_MODES = {"none": 0, "l2": 1, "zscore": 2, "zscore_l2": 3}
_MAX_SMEM = 232448  # bytes of shared memory one CTA may use on Hopper
# the kernel's tiling (csrc/windows_encoder.cu): a weight stage holds
# TILE_N output columns by TILE_K inputs (3xTF32) or TILE_K_BF16 inputs
# (bf16; the same 16 KB), its plane rows PLANE_PAD floats of padding
TILE_N, TILE_K, TILE_K_BF16, PLANE_PAD = 128, 16, 64, 4
# the kernel's route per matmul_precision (the C entry point's `route`)
ROUTES = {"highest": 0, "bf16": 1}


def layer_dims(config: GINConfig) -> tuple[tuple[int, int], ...]:
    """(in_width, out_width) per GINE layer; layer 0 reads the
    node-encoder width."""
    hd = config.hidden_dims
    return tuple((hd[i - 1] if i > 0 else hd[0], hd[i]) for i in range(config.gin_layers))


def windows_kernel_ok(config: GINConfig) -> bool:
    """The configs the kernel covers: the same gate as the TPU kernel's
    ``pallas_windows_ok`` (GraphNorm, add/mean pooling, every width and
    the output a multiple of 128)."""
    return (
        config.norm_type == "graph"
        and config.pooling_type in ("global_add_pool", "global_mean_pool")
        and config.node_embed_norm in _NORM_MODES
        and all(h % 128 == 0 for h in config.hidden_dims)
        and config.output_dim % 128 == 0
    )


def _edge_rows(config: GINConfig, conv: dict) -> torch.Tensor:
    """The four constant edge-class embeddings of one layer, ``[4, din]``,
    at the config's precision."""
    rows = torch.from_numpy(window_edge_const_rows(config.edge_feature_dim))
    return _dense(rows.to(conv["edge_lin"]["kernel"]), conv["edge_lin"],
                  config.matmul_precision)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero: ``cvt.rna.tf32.f32``), as float32 with the low 13 bits
    zero."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3xTF32 parts of ``x``: ``hi = tf32(x)``, ``lo = tf32(x - hi)``;
    ``hi + lo`` is ``x`` to about 2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def tile_weight(w: torch.Tensor) -> torch.Tensor:
    """A ``[din, dout]`` kernel as the window kernel streams it: ``W``
    transposed (``[dout, din]``, K-major, as tf32 ``wgmma`` reads B),
    split into hi and lo, and cut into stages of ``TILE_N`` columns by
    ``TILE_K`` inputs in the tensor cores' core-matrix order (8 rows of
    4 floats, 16 bytes each).  Flat order: ``[n tile, k stage, hi/lo,
    8-row group, 4-float chunk, row, float]``."""
    wt = w.to(torch.float32).t()
    N, K = wt.shape
    parts = []
    for part in tf32_split(wt):
        t = part.reshape(N // TILE_N, TILE_N // 8, 8, K // TILE_K, TILE_K // 4, 4)
        parts.append(t.permute(0, 3, 1, 4, 2, 5))
    return torch.stack(parts, dim=2).reshape(-1)


def tile_weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """A ``[din, dout]`` kernel as the window kernel's bf16 route streams
    it: ``W`` transposed (``[dout, din]``, K-major), rounded once to
    bfloat16 (to nearest, ties to even) and cut into stages of ``TILE_N``
    columns by ``TILE_K_BF16`` = 64 inputs (16 KB, the bytes of one 3xTF32
    stage, which covers 16 inputs) in the core-matrix order of bf16
    ``wgmma`` (8 rows of 8 values, 16 bytes each); one stage feeds four
    k16 ``wgmma``.  A bfloat16 tensor in the flat order ``[n tile, k
    stage, 8-row group, 8-value chunk, row, value]``."""
    wt = w.to(torch.float32).t().to(torch.bfloat16)
    N, K = wt.shape
    t = wt.reshape(N // TILE_N, TILE_N // 8, 8, K // TILE_K_BF16, TILE_K_BF16 // 8, 8)
    return t.permute(0, 3, 1, 4, 2, 5).reshape(-1)


class PackedParams(NamedTuple):
    """Every weight the kernel reads, in one flat float32 buffer, and
    the int64 table of where each part starts (``_LAYER_META`` entries
    per layer, then the zscore rows, the fc kernel and the fc bias, then
    per layer the tiled ``mlp0`` and ``mlp1`` kernels of
    :func:`tile_weight` or, at ``precision="bf16"``,
    :func:`tile_weight_bf16`)."""

    flat: torch.Tensor
    meta: torch.Tensor
    max_width: int
    precision: str = "highest"


def pack_params(config: GINConfig, params: dict, state: dict) -> PackedParams:
    """Pack the parameters on their own device, for the kernel's route of
    ``config.matmul_precision``.  Per layer: ``mlp0`` and ``mlp1`` kernels
    and biases, the edge rows ``[5, din]`` (the four edge-class
    embeddings at the config's precision, then ``1 + eps``) and the
    GraphNorm rows ``[3, dout]`` (weight, bias, mean_scale); then
    ``node_mu`` and ``node_sigma`` ``[2, h_last]`` and the fc head; then,
    for the tensor-core products, each layer's two kernels through
    :func:`tile_weight` (3xTF32) or :func:`tile_weight_bf16` (bf16, two
    values to a float32 slot), each starting on a 128-byte boundary."""
    precision = config.matmul_precision
    tile = tile_weight if precision == "highest" else (
        lambda w: tile_weight_bf16(w).view(torch.float32))
    parts: list[torch.Tensor] = []
    meta: list[int] = []
    size = 0

    def put(t: torch.Tensor) -> int:
        nonlocal size
        start = size
        parts.append(t.reshape(-1).to(torch.float32))
        size += t.numel()
        return start

    for i, (din, dout) in enumerate(layer_dims(config)):
        conv, norm = params["convs"][i], params["norms"][i]
        eb = torch.cat([_edge_rows(config, conv), (1.0 + conv["eps"]).expand(1, din)])
        gn = torch.stack([norm["weight"], norm["bias"], norm["mean_scale"]])
        meta += [
            put(conv["mlp0"]["kernel"]), put(conv["mlp1"]["kernel"]),
            put(conv["mlp0"]["bias"]), put(conv["mlp1"]["bias"]),
            put(eb), put(gn), din, dout,
        ]
    meta += [
        put(torch.stack([state["node_mu"], state["node_sigma"]])),
        put(params["fc"]["kernel"]),
        put(params["fc"]["bias"]),
    ]
    for conv in params["convs"][: config.gin_layers]:
        for name in ("mlp0", "mlp1"):
            if size % 32:
                put(torch.zeros(32 - size % 32, device=parts[0].device))
            meta.append(put(tile(conv[name]["kernel"])))
    flat = torch.cat(parts).contiguous()
    max_width = max(max(d) for d in layer_dims(config))
    return PackedParams(flat, torch.tensor(meta, dtype=torch.int64, device=flat.device),
                        max_width, precision)


def forward_windows_reference(config: GINConfig, params: dict, state: dict,
                              x0: torch.Tensor, j_local: torch.Tensor,
                              bp_in: torch.Tensor, pulled: torch.Tensor,
                              fwd_into_w: torch.Tensor, fwd_into_p: torch.Tensor,
                              L: int, precision: str | None = None,
                              exact_gather: bool = False) -> torch.Tensor:
    """Plain PyTorch encoder over a chunk of aligned windows.

    ``x0 [C, 2L, h0]``; ``j_local [C, L]`` the in-window partner of each
    position; ``bp_in``, ``pulled``, ``fwd_into_w``, ``fwd_into_p``
    ``[C, L]`` 0/1 flags.  Covers norm 'graph' and 'none' and any widths
    (the kernel's gate is narrower).  ``precision`` (default: the
    config's): at ``"bf16"`` it computes what the TPU kernel computes at
    ``Precision.DEFAULT``, with four rounding points: the two MLP
    products, the fc head and the in-window partner rows (unless
    ``exact_gather``, the XLA path's exact gather)."""
    prec = config.matmul_precision if precision is None else precision
    if prec != config.matmul_precision:
        config = config.with_precision(prec)
    round_partner = prec == "bf16" and not exact_gather
    C = x0.shape[0]
    f32 = torch.float32
    pos = torch.arange(L, device=x0.device)
    m_next = (pos <= L - 2).to(f32)[None, :, None]
    m_prev = (pos >= 1).to(f32)[None, :, None]
    pulled3 = pulled[..., None]
    bp3 = bp_in[..., None]
    fw3 = fwd_into_w[..., None]
    fp3 = fwd_into_p[..., None]
    mask = torch.cat([torch.ones((C, L), dtype=f32, device=x0.device), pulled], dim=1)
    mask3 = mask[..., None]
    counts = torch.clamp(mask.sum(dim=1), min=1.0)
    jl = j_local.long()

    x = x0
    for i in range(config.gin_layers):
        conv = params["convs"][i]
        h_in = x
        eb = _edge_rows(config, conv)  # adj_from_next, adj_from_prev, bp_f, bp_b
        xw = x[:, :L, :]
        xp = x[:, L:, :]
        zrow = torch.zeros_like(xw[:, :1, :])
        x_next = torch.cat([xw[:, 1:, :], zrow], dim=1)
        x_prev = torch.cat([zrow, xw[:, :-1, :]], dim=1)
        agg_w = torch.relu(x_next + eb[0]) * m_next + torch.relu(x_prev + eb[1]) * m_prev
        xj = torch.gather(xw, 1, jl[..., None].expand(-1, -1, xw.shape[2]))
        if round_partner:  # the TPU kernel's one-hot product G @ x
            xj = bf16_round(xj)
        e_bp_w = fw3 * eb[2] + (1.0 - fw3) * eb[3]
        agg_w = agg_w + torch.relu(xj + e_bp_w) * bp3
        agg_w = agg_w + torch.relu(xp + e_bp_w) * pulled3
        e_bp_p = fp3 * eb[2] + (1.0 - fp3) * eb[3]
        agg_p = torch.relu(xw + e_bp_p) * pulled3
        agg = torch.cat([agg_w, agg_p], dim=1)

        h = (1.0 + conv["eps"]) * x + agg
        hf = h.reshape(C * 2 * L, -1)
        hf = torch.relu(_dense(hf, conv["mlp0"], prec))
        hf = torch.relu(_dense(hf, conv["mlp1"], prec))
        h = hf.reshape(C, 2 * L, -1)
        if config.norm_type == "graph":
            p = params["norms"][i]
            cnt = counts[:, None, None]
            mean = (h * mask3).sum(dim=1, keepdim=True) / cnt
            out = h - mean * p["mean_scale"]
            var = ((out * out) * mask3).sum(dim=1, keepdim=True) / cnt
            h = p["weight"] * out / torch.sqrt(var + 1e-5) + p["bias"]
        if config.use_residual and h.shape == h_in.shape:
            h = h + h_in
        x = h

    if config.normalize_nodes_before_pool:
        x = apply_node_norm(config, state, x.reshape(C * 2 * L, -1)).reshape(C, 2 * L, -1)
    pooled = (x * mask3).sum(dim=1)
    if config.pooling_type == "global_mean_pool":
        pooled = pooled / counts[:, None]
    return _dense(pooled, params["fc"], prec)


_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' shared library, built and bound at first use."""
    global _lib
    if _lib is None:
        from ginfinity_tpu_torch.ops._build import build_library

        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.windows_encoder_launch.argtypes = (
            [p] * 10 + [i] * 9 + [ctypes.c_float, p]
        )
        lib.windows_encoder_launch.restype = i
        lib.windows_encoder_smem_bytes.argtypes = [i, i]
        lib.windows_encoder_smem_bytes.restype = ctypes.c_size_t
        lib.windows_encoder_smem_rows.argtypes = [i, i]
        lib.windows_encoder_smem_rows.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def forward_windows(config: GINConfig, params: dict, state: dict,
                    x0: torch.Tensor, j_local: torch.Tensor,
                    bp_in: torch.Tensor, pulled: torch.Tensor,
                    fwd_into_w: torch.Tensor, fwd_into_p: torch.Tensor,
                    L: int, packed: PackedParams | None = None) -> torch.Tensor:
    """The window encoder: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Arguments as
    :func:`forward_windows_reference`; ``packed`` is
    :func:`pack_params`'s result, made here when not given.  The kernel's
    route is the config's ``matmul_precision``.  Each kernel launch adds
    one to ``forward_windows.launches``, and each launch of the bf16 route
    also one to ``forward_windows.bf16_launches``."""
    if x0.device.type == "cpu":
        return forward_windows_reference(config, params, state, x0, j_local, bp_in,
                                         pulled, fwd_into_w, fwd_into_p, L)
    if x0.device.type != "cuda":
        raise ValueError(f"forward_windows: unsupported device {x0.device}")
    if not windows_kernel_ok(config):
        raise ValueError("forward_windows: config outside the kernel's gate "
                         "(windows_kernel_ok); use forward_windows_reference")
    dims = layer_dims(config)
    C, h0 = x0.shape[0], dims[0][0]
    if x0.dtype != torch.float32 or tuple(x0.shape) != (C, 2 * L, h0):
        raise ValueError(f"x0 must be float32 [C, {2 * L}, {h0}], got "
                         f"{x0.dtype} {tuple(x0.shape)}")
    if j_local.dtype != torch.int32:
        raise ValueError(f"j_local must be int32, got {j_local.dtype}")
    flags = (j_local, bp_in, pulled, fwd_into_w, fwd_into_p)
    for name, t in zip(("bp_in", "pulled", "fwd_into_w", "fwd_into_p"), flags[1:]):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    for t in (x0,) + flags:
        if t.device != x0.device or not t.is_contiguous():
            raise ValueError("forward_windows: inputs must be contiguous on one device")
    for t in flags:
        if tuple(t.shape) != (C, L):
            raise ValueError(f"window flags must be [{C}, {L}], got {tuple(t.shape)}")
    if packed is None:
        packed = pack_params(config, params, state)
    if packed.flat.device != x0.device:
        raise ValueError("packed parameters lie on another device than x0")
    if packed.precision != config.matmul_precision:
        raise ValueError(f"parameters packed for precision {packed.precision!r}, the config "
                         f"asks for {config.matmul_precision!r}")
    lib = _library()
    mw = packed.max_width
    smem = lib.windows_encoder_smem_bytes(L, mw)
    if smem > _MAX_SMEM:
        raise ValueError(f"window length {L} needs {smem} bytes of shared memory "
                         f"per CTA; the card offers {_MAX_SMEM}")
    out = torch.empty((C, config.output_dim), dtype=torch.float32, device=x0.device)
    if C == 0:
        return out
    # the planes of the windows with more active rows than shared memory holds
    workspace = torch.empty((C, 4, 2 * L, mw + PLANE_PAD), dtype=torch.float32,
                            device=x0.device)
    norm = config.node_embed_norm if config.normalize_nodes_before_pool else "none"
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.windows_encoder_launch(
            x0.data_ptr(), j_local.data_ptr(), bp_in.data_ptr(), pulled.data_ptr(),
            fwd_into_w.data_ptr(), fwd_into_p.data_ptr(), packed.flat.data_ptr(),
            packed.meta.data_ptr(), workspace.data_ptr(), out.data_ptr(),
            C, L, len(dims), mw, config.output_dim,
            int(config.pooling_type == "global_mean_pool"), _NORM_MODES[norm],
            int(config.use_residual), ROUTES[config.matmul_precision], float(config.eps),
            stream,
        )
    if err != 0:
        raise RuntimeError("windows_encoder launch failed: "
                           + lib.cuda_error_string(err).decode())
    forward_windows.launches += 1
    forward_windows.bf16_launches += config.matmul_precision == "bf16"
    return out


forward_windows.launches = 0
forward_windows.bf16_launches = 0
