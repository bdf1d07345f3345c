"""The fused window encoder: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``ginfinity_tpu/ops/pallas_windows.py``.  Given a chunk of
windows in the aligned layout (slot ``i < L`` holds window position
``i``, slot ``L + i`` the pulled outside partner of position ``i``) and
their post-node-encoder activations ``x0 [C, 2L, h0]``, both compute
every GINE layer, the node norm, the pooling and the fc head, and
return ``[C, out_dim]``.

:func:`forward_windows_reference` is the plain version (the tensor code
of the JAX package's aligned XLA path).  :func:`forward_windows` runs
the hand-written kernel ``csrc/windows_encoder.cu`` on a CUDA tensor and
the plain version on a CPU tensor; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ginfinity_tpu_torch.graphs.build import window_edge_const_rows
from ginfinity_tpu_torch.models.gine import GINConfig, _dense, apply_node_norm

_LAYER_META = 8  # per layer: w0, w1, b0, b1, eb, gn offsets; din; dout
_NORM_MODES = {"none": 0, "l2": 1, "zscore": 2, "zscore_l2": 3}
_MAX_SMEM = 232448  # bytes of shared memory one CTA may use on Hopper


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
    """The four constant edge-class embeddings of one layer, ``[4, din]``."""
    rows = torch.from_numpy(window_edge_const_rows(config.edge_feature_dim))
    return _dense(rows.to(conv["edge_lin"]["kernel"].device), conv["edge_lin"])


class PackedParams(NamedTuple):
    """Every weight the kernel reads, in one flat float32 buffer, and
    the int64 table of where each part starts (``_LAYER_META`` entries
    per layer, then the zscore rows, the fc kernel and the fc bias)."""

    flat: torch.Tensor
    meta: torch.Tensor
    max_width: int


def pack_params(config: GINConfig, params: dict, state: dict) -> PackedParams:
    """Pack the parameters on their own device.  Per layer: ``mlp0`` and
    ``mlp1`` kernels and biases, the edge rows ``[5, din]`` (the four
    edge-class embeddings, then ``1 + eps``) and the GraphNorm rows
    ``[3, dout]`` (weight, bias, mean_scale); then ``node_mu`` and
    ``node_sigma`` ``[2, h_last]`` and the fc head."""
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
    flat = torch.cat(parts).contiguous()
    max_width = max(max(d) for d in layer_dims(config))
    return PackedParams(flat, torch.tensor(meta, dtype=torch.int64, device=flat.device),
                        max_width)


def forward_windows_reference(config: GINConfig, params: dict, state: dict,
                              x0: torch.Tensor, j_local: torch.Tensor,
                              bp_in: torch.Tensor, pulled: torch.Tensor,
                              fwd_into_w: torch.Tensor, fwd_into_p: torch.Tensor,
                              L: int) -> torch.Tensor:
    """Plain PyTorch encoder over a chunk of aligned windows.

    ``x0 [C, 2L, h0]``; ``j_local [C, L]`` the in-window partner of each
    position; ``bp_in``, ``pulled``, ``fwd_into_w``, ``fwd_into_p``
    ``[C, L]`` 0/1 flags.  Covers norm 'graph' and 'none' and any widths
    (the kernel's gate is narrower)."""
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
        e_bp_w = fw3 * eb[2] + (1.0 - fw3) * eb[3]
        agg_w = agg_w + torch.relu(xj + e_bp_w) * bp3
        agg_w = agg_w + torch.relu(xp + e_bp_w) * pulled3
        e_bp_p = fp3 * eb[2] + (1.0 - fp3) * eb[3]
        agg_p = torch.relu(xw + e_bp_p) * pulled3
        agg = torch.cat([agg_w, agg_p], dim=1)

        h = (1.0 + conv["eps"]) * x + agg
        hf = h.reshape(C * 2 * L, -1)
        hf = torch.relu(_dense(hf, conv["mlp0"]))
        hf = torch.relu(_dense(hf, conv["mlp1"]))
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
    return _dense(pooled, params["fc"])


_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' shared library, built and bound at first use."""
    global _lib
    if _lib is None:
        from ginfinity_tpu_torch.ops._build import build_library

        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.windows_encoder_launch.argtypes = (
            [p] * 10 + [i] * 8 + [ctypes.c_float, p]
        )
        lib.windows_encoder_launch.restype = i
        lib.windows_encoder_smem_bytes.argtypes = [i, i]
        lib.windows_encoder_smem_bytes.restype = ctypes.c_size_t
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
    :func:`pack_params`'s result, made here when not given.  Each kernel
    launch adds one to ``forward_windows.launches``."""
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
    lib = _library()
    mw = packed.max_width
    smem = lib.windows_encoder_smem_bytes(L, mw)
    if smem > _MAX_SMEM:
        raise ValueError(f"window length {L} needs {smem} bytes of shared memory "
                         f"per CTA; the card offers {_MAX_SMEM}")
    out = torch.empty((C, config.output_dim), dtype=torch.float32, device=x0.device)
    if C == 0:
        return out
    workspace = torch.empty((C, 3, 2 * L, mw), dtype=torch.float32, device=x0.device)
    norm = config.node_embed_norm if config.normalize_nodes_before_pool else "none"
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.windows_encoder_launch(
            x0.data_ptr(), j_local.data_ptr(), bp_in.data_ptr(), pulled.data_ptr(),
            fwd_into_w.data_ptr(), fwd_into_p.data_ptr(), packed.flat.data_ptr(),
            packed.meta.data_ptr(), workspace.data_ptr(), out.data_ptr(),
            C, L, len(dims), mw, config.output_dim,
            int(config.pooling_type == "global_mean_pool"), _NORM_MODES[norm],
            int(config.use_residual), float(config.eps), stream,
        )
    if err != 0:
        raise RuntimeError("windows_encoder launch failed: "
                           + lib.cuda_error_string(err).decode())
    forward_windows.launches += 1
    return out


forward_windows.launches = 0
