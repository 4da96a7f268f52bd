"""Model FLOPs of CosyVoice2's detokenizer (the flow and HiFT) for one
window, counted from the configuration's ``model`` section and the shapes
the port computes (``reference/cosyvoice2.py`` spells out the same
mathematics).

A window of ``L`` tokens is

* the flow over ``K + L`` tokens (``K`` = 25 tokens of left context): the
  conformer encoder over the tokens, its x2 upsampling and the up-encoder
  over ``2 (K + L)`` frames, then ``n_timesteps`` Euler steps of the U-Net
  estimator, each one pass over a batch of two rows (classifier-free
  guidance: with and without the condition) of ``2 (K + L)`` frames;
* HiFT over the mel frames of its first ``L - 3`` tokens plus the 6 frames
  of carried context.

Counted: every matrix product and convolution (2 FLOPs a multiply-add),
attention's score and value products included, as
``torch.utils.flop_counter`` counts them. Left out, and named so: the STFT
and iSTFT (``torch.fft``), the overlap-add (``F.fold``), the embedding
lookup, and every elementwise op, norm and softmax.
"""

from __future__ import annotations

import math

from portbench.readers import traced_steps
from portbench.roofline import PEAK_OPS_PER_S

#: left-context tokens a window re-decodes, tokens of look-ahead it does
#: not emit, and HiFT's carried mel frames (the port's flow_common.py and
#: codecs/hifigan.py)
FLOW_CTX, OVERLAP, HIFT_CTX_FRAMES = 25, 3, 6


def _mm(rows: int, d_in: int, d_out: int) -> float:
    return 2.0 * rows * d_in * d_out


def _conv(out_len: int, k: int, c_in: int, c_out: int,
          batch: int = 1) -> float:
    return 2.0 * batch * out_len * k * c_in * c_out


def _conformer(f: dict, T: int) -> float:
    """One relative-position conformer block over T frames."""
    d, u = f["output_size"], f["linear_units"]
    return (4 * _mm(T, d, d)               # q, k, v, out
            + _mm(2 * T - 1, d, d)         # the position projection
            + 2.0 * T * T * d * 2          # q_u k^T and attention x v
            + 2.0 * T * (2 * T - 1) * d    # q_v pos^T
            + _mm(T, d, u) + _mm(T, u, d))


def encoder_flops(f: dict, T: int) -> float:
    """The flow's encoder over T tokens: embedding projection, the
    look-ahead convolutions, the conformers, the x2 upsampling, the
    up-conformers and the projection to mel."""
    d, din = f["output_size"], f["input_size"]
    total = _mm(T, din, d)
    total += _conv(T, f["pre_lookahead"] + 1, d, d) + _conv(T, 3, d, d)
    total += f["num_blocks"] * _conformer(f, T)
    T2 = 2 * T
    total += _conv(T2, 5, d, d) + _mm(T2, din, d)
    total += f["up_blocks"] * _conformer(f, T2)
    return total + _mm(T2, d, f["mel_dim"])


def estimator_flops(f: dict, frames: int, rows: int = 2) -> float:
    """One pass of the causal U-Net estimator over ``rows`` rows of
    ``frames`` mel frames."""
    ch, mel = f["est_channels"], f["mel_dim"]
    ted, est_in = 4 * ch, 4 * mel
    inner = f["est_heads"] * f["est_head_dim"]
    n = rows * frames

    def resnet(din, dout):
        return (_conv(frames, 3, din, dout, rows)
                + _mm(rows, ted, dout)
                + _conv(frames, 3, dout, dout, rows)
                + _conv(frames, 1, din, dout, rows))

    def blocks():
        one = (3 * _mm(n, ch, inner) + 2 * 2.0 * rows * frames * frames
               * inner + _mm(n, inner, ch) + _mm(n, ch, 4 * ch)
               + _mm(n, 4 * ch, ch))
        return f["est_n_blocks"] * one

    total = _mm(rows, est_in, ted) + _mm(rows, ted, ted)
    total += resnet(est_in, ch) + blocks() + _conv(frames, 3, ch, ch, rows)
    total += f["est_mid_blocks"] * (resnet(ch, ch) + blocks())
    total += resnet(2 * ch, ch) + blocks() + _conv(frames, 3, ch, ch, rows)
    total += _conv(frames, 3, ch, ch, rows)          # final block
    return total + _conv(frames, 1, ch, mel, rows)   # final projection


def flow_flops(f: dict, tokens: int) -> float:
    """The flow over ``tokens`` tokens: the speaker projection, the
    encoder and ``n_timesteps`` guided estimator passes (two rows each)."""
    return (_mm(1, f["spk_dim"], f["mel_dim"]) + encoder_flops(f, tokens)
            + f["n_timesteps"] * estimator_flops(f, 2 * tokens))


def _out_len(n: int, k: int, stride: int = 1, pad: int = 0,
             dilation: int = 1) -> int:
    return (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1


def _resblock(ch: int, n: int, k: int, dils) -> float:
    return sum(_conv(n, k, ch, ch) * 2 for _ in dils)


def hift_flops(h: dict, frames: int) -> float:
    """HiFT over ``frames`` mel frames: the F0 predictor, the harmonic
    source's projection, the upsampling stages with their source
    branches and resblocks, and the output convolution."""
    rates = list(h["upsample_rates"])
    samples = frames * math.prod(rates) * h["hop_len"]
    cin, fc = h["in_channels"], h["f0_cond_channels"]
    total = _conv(frames, 3, cin, fc) + 4 * _conv(frames, 3, fc, fc)
    total += _mm(frames, fc, 1)
    total += _mm(samples, h["nb_harmonics"] + 1, 1)
    n_fft = h["n_fft"]
    stft_frames = samples // h["hop_len"] + 1
    total += _conv(frames, 7, cin, h["base_channels"])
    # the source branch's strides: products of the later rates
    downs = [math.prod(rates[i + 1:]) for i in range(len(rates))]
    n = frames
    for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
        c_in = h["base_channels"] // 2 ** i
        c = c_in // 2
        total += _conv(n, k, c_in, c)  # transposed: on its input length
        n = (n - 1) * u - 2 * ((k - u) // 2) + k
        if i == len(rates) - 1:
            n += 1                          # the reflect pad
        d = downs[i]
        sk = 1 if d == 1 else 2 * d
        sn = (stft_frames if d == 1
              else _out_len(stft_frames, sk, d, d // 2))
        total += _conv(sn, sk, n_fft + 2, c)
        total += _resblock(c, sn, h["source_resblock_kernel_sizes"][i],
                           h["resblock_dilations"][i])
        for k2, dils in zip(h["resblock_kernel_sizes"],
                            h["resblock_dilations"]):
            total += _resblock(c, n, k2, dils)
    final = h["base_channels"] // 2 ** len(rates)
    return total + _conv(n, 7, final, n_fft + 2)


def window_flops(m: dict, length: int) -> float:
    """One detokenize window of ``length`` tokens: the flow over the
    context and the window, HiFT over the emitted frames and its carried
    context."""
    f = m["flow"]
    emitted = (length - OVERLAP) * f["token_mel_ratio"]
    return (flow_flops(f, FLOW_CTX + length)
            + hift_flops(m["hift"], HIFT_CTX_FRAMES + emitted))


# ---------------------------------------------------------------------------
# what the per-layer metrics read
# ---------------------------------------------------------------------------


def part_ms(ctx, part: str):
    """Device ms per replay of one timed part of the detokenize graphs
    (the port's ``phase_stats`` "detok.<part>"; None where the program
    times no such part)."""
    tot, n = ctx.stats["phase_stats"].get(f"detok.{part}", (0.0, 0))
    return tot / n * 1e3 if n else None


def detok_share(ctx):
    """% of the bf16 peak reached by the traced ``pb_detok`` calls: their
    windows (a call's requests) at the mean FLOPs of the windows the
    completed requests list, over the calls' device time."""
    steps = traced_steps(ctx, "detok")
    dev_s = sum(r["device_s"] for _, r in steps)
    lengths = [w[1] for req in ctx.stats.get("requests", [])
               for w in req.get("detok_windows", [])]
    if dev_s <= 0 or not lengths:
        return None
    per_window = sum(window_flops(ctx.model, L) for L in lengths) / len(
        lengths)
    windows = sum(c[0] for c, _ in steps)
    return 100.0 * windows * per_window / (dev_s * PEAK_OPS_PER_S["bf16"])
