"""The CAMPPlus speaker x-vector network (port of
vox_serve_tpu/encoders/campplus.py): CosyVoice2's voice-clone x-vector.

An FCM 2-D conv head (a frequency-downsampling ResNet), a TDNN stem, three
CAM dense-TDNN blocks (12 / 24 / 16 layers, growth 32, context-aware
masking with 100-frame segment pooling), transit layers, and statistics
pooling into a 192-d embedding. Its input is 80-mel Kaldi-style fbank rows
with the utterance mean subtracted (``kaldi_fbank``, numpy). CosyVoice2
publishes the weights as ``campplus.onnx`` (tensors extracted by
``onnx_reader``); torch-format conversions map through the same loader.
It runs eagerly on the model's device at preprocess time, as the JAX
package runs it outside any Pallas kernel; the batch norms are in
inference form (running statistics).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..weights import to_device

BLOCK_SPECS = ((12, 3, 1), (24, 3, 2), (16, 3, 2))  # (layers, kernel, dil)
GROWTH = 32
BN_SIZE = 4
INIT_CHANNELS = 128


# ---------------------------------------------------------------------------
# fbank front end (Kaldi-style: 25 ms / 10 ms, HTK mel, per-utterance mean
# subtraction), numpy
# ---------------------------------------------------------------------------
def kaldi_fbank(wav: np.ndarray, sr: int = 16000, n_mels: int = 80
                ) -> np.ndarray:
    """(S,) -> (T, n_mels) log-mel rows, mean-subtracted (Kaldi's fbank
    approximated on the host: povey window ~ hann ** 0.85, snip_edges)."""
    frame_len = int(0.025 * sr)
    hop = int(0.010 * sr)
    x = np.asarray(wav, np.float32)
    if len(x) < frame_len:
        x = np.pad(x, (0, frame_len - len(x)))
    n_frames = 1 + (len(x) - frame_len) // hop
    frames = np.lib.stride_tricks.sliding_window_view(
        x, frame_len)[::hop][:n_frames].copy()
    frames -= frames.mean(axis=1, keepdims=True)  # remove_dc_offset
    window = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_len)
                                 / (frame_len - 1))) ** 0.85
    n_fft = 1 << (frame_len - 1).bit_length()
    spec = np.abs(np.fft.rfft(frames * window, n=n_fft, axis=-1)) ** 2

    # HTK mel filterbank (Kaldi's scale, no area normalization)
    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_bins)

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    def imel(m):
        return 700.0 * (np.exp(m / 1127.0) - 1.0)

    pts = imel(np.linspace(mel(20.0), mel(sr / 2), n_mels + 2))
    fb = np.zeros((n_mels, n_bins), np.float32)
    for i in range(n_mels):
        lo, c, hi = pts[i], pts[i + 1], pts[i + 2]
        fb[i] = np.maximum(0, np.minimum((freqs - lo) / max(c - lo, 1e-9),
                                         (hi - freqs) / max(hi - c, 1e-9)))
    feat = np.log(np.maximum(spec @ fb.T, 1e-10))
    return (feat - feat.mean(axis=0, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# weight mapping
# ---------------------------------------------------------------------------
def load_campplus_params(sd: dict, prefix: str = "", *,
                         device="cpu") -> dict:
    """Map the published tensors (numpy arrays from the ONNX reader, or
    torch tensors) onto the parameter tree, float32 on ``device``."""
    def arr(n):
        a = sd[prefix + n]
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return to_device(t, device, torch.float32)

    def conv(n, bias=False):
        p = {"w": arr(f"{n}.weight")}
        if bias and f"{prefix}{n}.bias" in sd:
            p["b"] = arr(f"{n}.bias")
        return p

    def bn(n, affine=True):
        p = {"mean": arr(f"{n}.running_mean"), "var": arr(f"{n}.running_var")}
        if affine:
            p["scale"] = arr(f"{n}.weight")
            p["bias"] = arr(f"{n}.bias")
        return p

    def res2d(n):
        p = {"conv1": conv(f"{n}.conv1"), "bn1": bn(f"{n}.bn1"),
             "conv2": conv(f"{n}.conv2"), "bn2": bn(f"{n}.bn2")}
        if f"{prefix}{n}.shortcut.0.weight" in sd:
            p["sc_conv"] = conv(f"{n}.shortcut.0")
            p["sc_bn"] = bn(f"{n}.shortcut.1")
        return p

    head = {"conv1": conv("head.conv1"), "bn1": bn("head.bn1"),
            "conv2": conv("head.conv2"), "bn2": bn("head.bn2"),
            "layer1": [res2d(f"head.layer1.{i}") for i in range(2)],
            "layer2": [res2d(f"head.layer2.{i}") for i in range(2)]}

    def nonlin(n):
        return bn(f"{n}.batchnorm")

    def cam_dense(n):
        return {
            "nl1": nonlin(f"{n}.nonlinear1"),
            "lin1": conv(f"{n}.linear1"),
            "nl2": nonlin(f"{n}.nonlinear2"),
            "local": conv(f"{n}.cam_layer.linear_local", bias=True),
            "cam1": conv(f"{n}.cam_layer.linear1", bias=True),
            "cam2": conv(f"{n}.cam_layer.linear2", bias=True),
        }

    xv = {"tdnn_conv": conv("xvector.tdnn.linear"),
          "tdnn_bn": nonlin("xvector.tdnn.nonlinear"),
          "blocks": [], "transits": []}
    for bi, (n_layers, _, _) in enumerate(BLOCK_SPECS, start=1):
        xv["blocks"].append(
            [cam_dense(f"xvector.block{bi}.tdnnd{j + 1}")
             for j in range(n_layers)])
        xv["transits"].append({
            "nl": nonlin(f"xvector.transit{bi}.nonlinear"),
            "lin": conv(f"xvector.transit{bi}.linear"),
        })
    xv["out_bn"] = nonlin("xvector.out_nonlinear")
    xv["dense_lin"] = conv("xvector.dense.linear")
    xv["dense_bn"] = bn("xvector.dense.nonlinear.batchnorm", affine=False)
    return {"head": head, "xvector": xv}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _bn(p, x):
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(p["var"] + 1e-5)
    y = (x - p["mean"].reshape(shape)) * inv.reshape(shape)
    if "scale" in p:
        y = y * p["scale"].reshape(shape) + p["bias"].reshape(shape)
    return y


def _conv2d(p, x, stride=(1, 1), padding=1):
    return F.conv2d(x, p["w"], p.get("b"), stride=stride, padding=padding)


def _conv1d(p, x, stride=1, padding=0, dilation=1):
    return F.conv1d(x, p["w"], p.get("b"), stride=stride, padding=padding,
                    dilation=dilation)


def _res2d(p, x, stride):
    out = F.relu(_bn(p["bn1"], _conv2d(p["conv1"], x, (stride, 1))))
    out = _bn(p["bn2"], _conv2d(p["conv2"], out))
    if "sc_conv" in p:
        k = p["sc_conv"]["w"].shape[-1]
        sc = _bn(p["sc_bn"], _conv2d(p["sc_conv"], x, (stride, 1),
                                     padding=(k - 1) // 2))
    else:
        sc = x
    return F.relu(out + sc)


def _bn_relu(p, x):
    return F.relu(_bn(p, x))


def _cam_dense_layer(p, x, kernel, dilation):
    h = _conv1d(p["lin1"], _bn_relu(p["nl1"], x))
    h = _bn_relu(p["nl2"], h)
    # CAM: a local conv modulated by a sigmoid of the context (the global
    # mean + 100-frame segment means)
    pad = (kernel - 1) // 2 * dilation
    y = _conv1d(p["local"], h, padding=pad, dilation=dilation)
    T = h.shape[-1]
    seg_len = 100
    n_seg = -(-T // seg_len)
    h_pad = F.pad(h, (0, n_seg * seg_len - T))
    seg_sum = h_pad.reshape(*h.shape[:2], n_seg, seg_len).sum(-1)
    starts = np.arange(n_seg) * seg_len
    seg_cnt = torch.from_numpy(
        (np.minimum(starts + seg_len, T) - starts).astype(np.float32)
    ).to(h.device)
    seg = seg_sum / seg_cnt[None, None, :]
    seg = torch.repeat_interleave(seg, seg_len, dim=-1)[..., :T]
    context = h.mean(-1, keepdim=True) + seg
    m = torch.sigmoid(_conv1d(p["cam2"],
                              F.relu(_conv1d(p["cam1"], context))))
    return y * m


def campplus_embed(params: dict, feat: torch.Tensor) -> torch.Tensor:
    """feat (B, T, 80) fbank rows -> (B, 192) x-vector."""
    x = feat.transpose(1, 2)[:, None]                          # (B, 1, F, T)
    h = params["head"]
    x = F.relu(_bn(h["bn1"], _conv2d(h["conv1"], x)))
    for i, blk in enumerate(h["layer1"]):
        x = _res2d(blk, x, 2 if i == 0 else 1)
    for i, blk in enumerate(h["layer2"]):
        x = _res2d(blk, x, 2 if i == 0 else 1)
    x = F.relu(_bn(h["bn2"], _conv2d(h["conv2"], x, (2, 1))))
    B, C, Fq, T = x.shape
    x = x.reshape(B, C * Fq, T)

    xv = params["xvector"]
    x = _bn_relu(xv["tdnn_bn"], _conv1d(xv["tdnn_conv"], x, stride=2,
                                        padding=2))
    for (_, kernel, dilation), blk, transit in zip(
            BLOCK_SPECS, xv["blocks"], xv["transits"]):
        for lp in blk:
            x = torch.cat([x, _cam_dense_layer(lp, x, kernel, dilation)],
                          dim=1)
        x = _conv1d(transit["lin"], _bn_relu(transit["nl"], x))
    x = _bn_relu(xv["out_bn"], x)

    # statistics pooling (mean + unbiased std) -> dense -> affine-free BN
    mean = x.mean(-1)
    std = torch.sqrt(torch.clamp(x.var(-1, unbiased=True), min=0.0))
    stats = torch.cat([mean, std], dim=-1)[:, :, None]
    out = _bn(xv["dense_bn"], _conv1d(xv["dense_lin"], stats))
    return out[:, :, 0]
