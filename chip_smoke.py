#!/usr/bin/env python3
"""Smoke test of the PyTorch port (vox_serve_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without printing a result:

1. device: requires CUDA; prints ``nvidia-smi``'s name and power limit.
2. build: compiles the port's CUDA kernels (csrc/*.cu, sm_90a) with nvcc,
   one process per source, in parallel.
3. paged decode attention at Qwen3-TTS-1.7B talker shapes (B in {1, 4, 8,
   64}, H=16, KH=8, D=128, page 16, 28 layers, 4096 pages so pool offsets
   pass 2^31), random non-contiguous block tables, seq_lens up to ~1000
   (40-120 at B=4, the served batch) and one padded row; each kernel
   against its plain PyTorch version on the same inputs, with CUDA-event
   times of both: K1 over the combined bf16 pool, K1q over int8 and float8
   e4m3 pools (same scales on both sides), K4 over the head-major bf16 pair.
   Then K1 at Orpheus-3B's heads (H=24, KH=8: a GQA group of 3) at B=4 and
   64, at Step-Audio-2-mini's (H=28, KH=4: a group of 7, 4 + 3 heads per
   CTA) at B=4 and 64, at
   CSM-1B's (H=32, KH=8, head dim 64: a group of 4) at B=4 and 64, at
   CosyVoice2's Qwen2-0.5B (H=14, KH=2, head dim 64: a group of 7) at B=4
   and 64, at GLM-4-Voice-9B's (H=32, KH=2, head dim 128: a group of
   16, four CTAs of 4 heads per KV head) at B=4 and 64, at Chatterbox's
   T3 (H=16, KH=16, head dim 64: a group of 1, one head per CTA) at B in
   {1, 4, 8, 64}, at Zonos-v0.1's (H=16, KH=16, head dim 128) at B in
   {1, 4, 8, 64}, and at one rank's heads at ``--tp-size 4`` (B=4 and 64):
   the flagship's 4 over 2 and GLM-4-Voice-9B's 8 over its one KV head.
4. K3 ragged prefill attention vs its plain version at T in {64, 168, 256,
   1024} with 1-5 ragged segments (T=168: four 42-token prompts, the served
   prefill; valid rows compared); CUDA-event times of K3, its plain version
   and its library yardstick (one ``scaled_dot_product_attention`` call
   with the block-diagonal causal mask; the port never calls it). Then K3
   at G = 3 (T=168 and 1024), Step-Audio-2-mini's G = 7 (T=168 and
   1024), CSM's G = 4 at head dim
   64 (T=168 and 1024), CosyVoice2's G = 7 at head dim 64 (T=168 and
   1024), GLM-4-Voice's G = 16 at head dim 128 (T=168 and 1024),
   Chatterbox's G = 1 at head dim 64 and Zonos's G = 1 at head dim 128
   (T=168 and 1024: 32- and 64-token tiles), and the two ``--tp-size 4``
   rank layouts, 4 over 2 and 8 over 1 (T=168 and 1024). Then K6, the
   depth layer's four kernels, each against its plain version at
   Qwen3-TTS's and CSM's depth stacks, B in {1, 16, 128} (attention's
   yardstick: SDPA with the causal mask over the same cache).
   Every kernel line also gives its bound: the larger of its bytes over
   3.35 TB/s and its operations over the H100's peak for the inputs' type.
   Then a small-width talker backbone (prefill + 3 decode steps over the
   paged pool) on the card through the kernels, against the same weights
   on the CPU in float32 through the plain versions, for the combined bf16,
   int8 and float8 pools and the pair layout, and once each at a GQA group
   of 3 (Orpheus) and of 4 at head dim 64 (CSM), with Llama-3.1 rope
   scaling, and once at Orpheus's heads with int8 weights (quantized once
   on the CPU): the card through K5, 4 launches per layer and step,
   against the CPU through K5's plain version.
   Then tensor parallelism on the one card: the flagship's talker
   backbone (2048 wide, 16 / 8 heads, MLP 6144) and GLM-4-Voice-9B's
   (4096 wide, 32 / 2 heads, MLP 13696, q/k/v biases) at full width over
   4 of their layers, random weights, split by ``shard_params`` at tp 2
   and 4 (in bf16, and at int8: quantized whole, split, each shard packed)
   and run rank after rank with the partial sums added in place of each
   all-reduce (``backbone_forward_shards``), against the whole backbone on
   the same inputs: a T=168 prefill of four 42-token prompts and three
   B=4 decode steps, within 5e-2 of the whole one's peak in bf16; each
   rank's K1 / K3 (and K5) launches counted, each rank's pool held against
   its KV heads' rows of the whole pool.
   Then K5, the int8 weight-only linear (``--weight-quant int8``), for the
   seven linears of one layer (q, k, v, o, gate, up, down) as a group of
   four launches (q/k/v and gate/up each one launch, as the backbone makes
   them) at Qwen3-TTS (2048 / 6144), Orpheus (3072 / 8192), GLM-4-Voice
   (4096 / 13696, q/k/v biases), Step-Audio-2 (3584 / 18944, q/k/v
   biases) and Chatterbox (1024 / 4096) widths and one ``--tp-size 4``
   rank's (the flagship: q 512, k/v 256, o from 512, gate/up 1536, down
   from 1536; GLM: q 1024, k/v 128, o from 1024, gate/up 3424, down from
   3424), at M in {1, 4, 32, 64}
   rows (decode) and T in {168, 1024} (prefill), each output against its
   plain version on the same inputs; CUDA-graph times of K5, its plain
   version, bf16 ``x @ w`` of the unquantized weights (the path int8
   replaces) and, up to 168 rows, ``torch._weight_int8pack_mm`` (the
   library yardstick, where the card's PyTorch has a CUDA kernel for it;
   ~0.5 s a group at 1024 rows), and the group's bound; then an odd shape
   (K=200, N=300, layer 1 of a stack, padded by the pack) alone and as a
   group of three, for the tails.
   Then K2, the codec's residual-unit stack, against its plain version at
   the four decoder-block shapes of a detokenize of 4 streams x 10 frames
   and of one stream (B=4 and B=1), whole and as two streamed chunks with
   caches, with CUDA-event times and TFLOP/s per block and summed: in
   float32 (3xTF32) and in bf16 (the codec served at ``--codec-dtype
   bfloat16``; against the bf16 plain version, the Pallas kernel's
   rounding points).
   Then CSM's codec path at full width: the Mimi decoder (random weights
   from a seed) for 4 streams x 10 frames, whole and as two streamed
   chunks with caches, on the card against the CPU in float32 and in bf16
   against float32; the spectral watermark over a 19,200-sample chunk per
   stream and SilentCipher's encode (random params, one chunk at 44.1
   kHz), card vs CPU; CUDA-event times of each.
5. end to end over HTTP: ``python -m vox_serve_tpu_torch.launch --model
   qwen3-tts --device cuda`` serves Qwen3-TTS-12Hz-1.7B-CustomVoice at full
   width (28x2048 talker, 5x1024 depth, default codec; random weights from a
   seed) under eight configurations in turn: A (default: K1, K3), B
   (``--kv-quant int8`` with ``VOX_FUSED_RESUNIT=1``: K1q, K3, K2), C
   (``--kv-quant f8_e4m3``: K1q, K3), D (``VOX_KV_COMBINED=0``: K4, K3), E
   (A with ``--fused-decode-steps 4 --fused-decode-buckets 1,4
   --pipeline-depth 2``: fused k-step decode graphs, pipelined readback
   and ``poll_resolved``) and F (A with ``--first-chunk-frames 3
   --fused-decode-steps 4 --fused-decode-buckets 1,4 --pipeline-depth 2
   --detok-pipeline-depth 2``: the cold-start chain, the first-chunk ramp's
   mini detokenize windows, detokenize two deep), G (A with ``--codec-dtype
   bfloat16 --scheduler-type input_streaming --kv-reserve-fraction 0.05``
   and ``VOX_FUSED_RESUNIT=1``: K1, K3 and K2 in bf16; two of its four
   streams send their text in three pieces ~150 ms apart through
   /generate/stream/start, /text, /end and read /audio) and H (A with
   ``--scheduler-type offline --codec-dtype bfloat16``: the unfused bf16
   codec; every detokenize replay must come after the last LM step). Run I
   serves ``--model orpheus`` (Orpheus-3B: 28 x 3072 Llama-3.2-3B, 24 heads
   over 8 KV heads, vocab 156,940, Llama-3.1 rope; the float32 SNAC 24 kHz
   decoder; random weights from the seed) with ``--max-tokens 160``: K1 and
   K3 at G = 3, single-step decode graphs, detokenize graphs over
   overlapped 28-token windows every 7 tokens, no first-chunk ramp; each
   stream's PCM must be exactly what the overlap trim rule gives for the
   audio tokens its daemon reports (``requests`` in the stats file), at
   least 6 windows; it prints TTFA, windows/s against real time (11.72 per
   stream) and the decode and detokenize replay times. Run Y is I at
   ``--weight-quant int8``: the worker quantizes and packs the backbone's
   matmul weights before it captures anything, so every prefill and decode
   graph runs K5, 4 x 28 launches per replay (q/k/v and gate/up grouped),
   none eagerly; the daemon must
   report ``weight_quant: int8`` and a backbone of at most 0.55 of I's
   bytes, each stream's PCM is held to I's overlap rule, and Y is printed
   beside I (decode step, TTFA, windows/s, bytes). Every other run must
   report ``weight_quant: none`` and launch K5 no time. In every other run
   each stream's PCM is exactly what the trim rule gives for the frames its
   daemon reports (with F's and K's ramp: whole, or half a frame short).
   Runs J and K serve
   ``--model csm`` (CSM-1B: a 16 x 2048 Llama-3.2-1B backbone, 32 heads
   over 8 KV heads at head dim 64, a 4 x 1024 depth decoder sampling 31
   codebooks per step, the Mimi codec with its transformer ring in the slot
   cache, the spectral watermark in every detokenize graph; random
   weights from the seed) with ``--max-tokens 100``: J with default flags,
   K with ``--codec-dtype bfloat16 --first-chunk-frames 3
   --fused-decode-steps 4 --fused-decode-buckets 1,4 --pipeline-depth 2
   --detok-pipeline-depth 2`` (no cold chain: CSM's rows do not chain).
   The daemon must report the spectral watermark; K1 and K3 launch 16
   times per decode step and per prefill replay; each stream's PCM is
   what the trim rule gives for the audio tokens its daemon reports (with
   K's ramp, whole or half a frame short); each prints frames/s per stream
   against real time (12.5).
   Run O serves ``--model cosyvoice2`` (CosyVoice2-0.5B: a 24 x 896
   Qwen2 talker with q/k/v biases, 14 heads over 2 KV heads at head dim
   64; detokenize graphs holding the flow, 10 cosine Euler steps with
   classifier-free guidance on a doubled batch, and streaming HiFT, over
   overlapped 28-token windows every 25 tokens and the 53- and 103-token
   catch-up windows, with the flow cache in the slot; the codec in
   float32; random weights from the seed) with A's flags and
   ``--max-tokens 160``: K1 and K3 only, 24 launches per decode step and
   prefill; each stream's PCM is what the overlap rule gives (24,000
   samples per 25 tokens, the last window trimmed), at least 4 windows; it
   prints TTFA, windows/s against real time (1 per stream), the decode
   and detokenize replay times and the detokenize graphs' capture seconds
   and pool growth.
   Run Q serves ``--model glm`` (GLM-4-Voice-9B: the 40 x 4096 GLM-4
   backbone with ChatGLM's interleaved partial rope, 32 heads over 2 KV
   heads at head dim 128, q/k/v biases, vocab 168,960; detokenize graphs
   holding the GLM flow (a block conformer, the regulator, 10 CFG Euler
   steps of a U-Net on a doubled batch) and 22.05 kHz HiFT with its cache
   in the slot, over 25-token windows with no overlap and the 50- and
   100-token catch-up windows; random weights from the seed) with A's
   flags and ``--max-tokens 1600``: two streams upload a 3 s WAV and no
   text (speech to speech: the Whisper-VQ encoder on the card in
   preprocess, 38 speech tokens inlined as ``<|audio_k|>`` strings), two
   send text. K1 and K3 only, 40 launches per decode step and prefill;
   each prompt exactly as long as its template (this process encodes the
   same WAV with the same Whisper-VQ weights); each stream's PCM is what
   the trim rule gives over the windows its daemon reports (44,032
   samples per full 25-token window, 22,050 Hz), at least two full
   windows for every stream that ran to its cap (a stream that sampled a
   stop id earlier is printed); it prints TTFA (random weights: ~240
   decode steps a window), windows/s against real time, the decode and
   detokenize replay times, the detokenize graphs' capture and the
   daemon's memory after the model's init.
   Run S serves ``--model step-audio-2`` (Step-Audio-2-mini: the 28 x
   3584 Qwen2.5-7B backbone with q/k/v biases, 28 heads over 4 KV heads at
   head dim 128, vocab 158,720, top-p 0.9 at T 0.7 with a global
   repetition penalty; detokenize graphs holding the DiT flow (the Cosy
   conformer with 3 lookahead tokens, 10 CFG Euler steps of 16 adaLN DiT
   blocks on a doubled batch) and 24 kHz HiFT with its cache in the slot,
   over 28-token windows every 25 tokens and the 53- and 103-token
   catch-up windows; random weights from the seed) with A's flags and the
   family's ``--max-tokens 2048``: two streams upload a 3 s WAV and no
   text (speech to speech: the Whisper-style encoder and the adaptor on
   the card in preprocess, 18 rows spliced over the prompt's ``<audio>``
   markers), two send text. K1 and K3 only, 28 launches per decode step
   and prefill; each prompt exactly as long as its template and each
   upload's 18 spliced rows counted by the daemon (``feature_rows``); each
   stream's PCM is what the overlap rule gives (24,000 samples per 25
   tokens, the last window trimmed, 24,000 Hz), at least two full windows
   for every stream that ran to its cap; it prints TTFA (random weights:
   ~630 decode steps to the first window), windows/s, the decode, prefill
   and detokenize replay times, the encoder's preprocess wall, the
   detokenize graphs' capture and the daemon's memory after init.
   Run U serves ``--model chatterbox`` (Chatterbox: the 30 x 1024 T3 Llama
   backbone, 16 heads over 16 KV heads at head dim 64, Llama-3.1 rope at
   theta 5e5, speech vocab 6,563 with top-p 0.95 at T 0.8 and a global
   repetition penalty; learned text positions in the host-made prompt rows
   and learned speech positions added by ``gen_idx`` inside every decode
   graph; detokenize graphs holding the CosyVoice flow and 24 kHz HiFT over
   25-token windows every 22 tokens and the 47- and 91-token catch-up
   windows, then the watermark; random weights from the seed) with A's
   flags and ``--max-tokens 220``: four text streams (the dev tokenizer
   spells each space "[SPACE]": prompts of 92-98 rows), K1 and K3 only, 30
   launches per decode step and prefill, the dev spectral watermark (no
   Perth snapshot); each prompt exactly as long as its rows, every prompt
   row a feature row; each stream's PCM is what the overlap rule gives
   (21,120 samples per 22 tokens, the last window trimmed), at least 4
   windows for every stream that ran to its cap; it prints TTFA,
   windows/s, the decode, prefill and detokenize replay times, the
   detokenize graphs' capture and the init memory.
   Run W serves ``--model zonos`` (Zonos-v0.1: the 26 x 2048 LayerNorm
   backbone, 16 heads over 16 KV heads at head dim 128, 9 codebooks of
   1,025 ids sampled together with min_p and a repetition window, the
   delay pattern's mask applied by ``gen_idx`` inside every graph;
   detokenize graphs holding the delay revert, DAC 44.1 kHz and the 24 kHz
   resample over 50-token windows every 41 tokens; random weights from the
   seed) with A's flags and ``--max-tokens 220``: four text streams (39
   prompt rows each: the text's phonemes between BOS and EOS and six
   conditioning rows, every row a feature row), K1 and K3 only, 26
   launches per decode step and prefill; each stream's PCM is what the
   overlap rule gives (11,425 samples per 41 tokens, the last window
   trimmed), at least 4 windows for every stream that ran to its cap and
   2 in some stream (EOS is 1 of 1,025 ids on codebook 0: under random
   heads most streams sample it before their cap).
   Every prefill, decode
   step, detokenize, chained first-chunk decode and cold chain of every
   run is a replay of a CUDA graph captured at the daemon's start-up. Each
   run serves 4 concurrent streaming /generate requests that must return
   non-empty PCM16; F first serves one stream alone (the scheduler then
   takes the cold chain) and prints its TTFA beside A's median. The
   scheduler daemon zeroes its counters before its loop starts and writes
   them, with the configuration it served, when terminated: each run must
   show its model, KV layout, pool dtype, codec path, watermark and decode
   settings, launch
   its kernels and none of the others, replay prefill, decode and
   detokenize graphs and call no step body eagerly, launch K3 28 times per
   prefill or cold-chain replay and its decode kernel 28 times per decode
   step taken (a fused, chained or cold-chain replay takes k steps), and
   launch every kernel exactly as often as its graphs' replays times what
   their captures counted (B and G: K2's stacks too; the codec's tensors
   are read back as bf16 in G and H). E must replay fused graphs
   and hold two steps in flight, and is compared with A (within 20% of A's
   frames/s, a miss printed, not fatal); F must replay a cold chain and
   3- and 6-frame detokenize graphs and hold two detokenize batches in
   flight. Each run prints its decode step's and detokenize's wall time,
   each graph's device ms per replay from the start-up probe, the capture
   time and graph pool size, TTFA and aggregate frames/s; G prints its text
   streams' TTFA (first piece to first PCM byte) beside its /generate
   streams'.
   The launcher fills every serving-profile flag a run leaves unset from
   its model's profile (``vox_serve_tpu_torch/profiles.py``: Qwen3-TTS,
   CSM-1B and Orpheus-3B have one), so every run above passes
   ``--max-batch-size 4 --max-num-pages 2048`` and each profile flag it
   does not name at the value these runs served before (``PINNED``: page
   16, no pipelines, no ramp, no fused decode, the float32 codec, prefill
   buckets 128 and 1024 over 8 rows, the whole generation budget reserved).
   Run Z then serves the flagship as its users start it: ``--model
   qwen3-tts`` with no batch, page, lattice, pipeline or codec flag (only
   the port, socket suffix, seed, ``--max-tokens 100`` and the stats
   file), so its H100 profile applies; the daemon must report the
   profile's batch, pages, page size, decode and prefill buckets,
   pipelines, fused decode and codec dtype; one wave of as many streams
   as the profile's top decode bucket must replay the full-batch decode
   graphs, K1 and K3 only, all in graphs; every stream's PCM follows the
   trim rule; it prints the ready and capture seconds, the pages, the
   init memory and each card's memory after start-up, frames/s and the
   TTFA median.

6. checkpoints in the published layouts (``synthetic_checkpoints.py``):
   random weights from seeds at the published widths and tensor names,
   written with the port's safetensors writer (or ``torch.save`` where the
   published repo ships ``.bin`` / ``.ckpt`` files) into a temporary
   Hugging Face hub cache, one family at a time, each resolved by its id
   through ``HF_HUB_CACHE`` and loaded onto the card by the package's
   loaders, every tensor held bit-equal to the one written, with the bytes,
   seconds, GB/s and the peak resident set of each load printed:
   Qwen/Qwen3-TTS-12Hz-1.7B-Base (talker, depth and ``speaker_encoder.*``,
   bf16), Qwen/Qwen3-TTS-Tokenizer-12Hz (the decoder and the 32-codebook
   ``encoder.*`` Mimi model, float32), sesame/csm-1b (with
   ``codec_model.*`` and two 0.96 s prompt WAVs),
   canopylabs/orpheus-3b-0.1-ft at full width but 4 of its 28 layers,
   hubertsiuzdak/snac_24khz (``pytorch_model.bin``, weight-norm pairs) and
   sony/silentcipher (its three state dicts and ``hparams.yaml``, at the
   512-row band of phase 4). Between them it serves, each daemon resolving
   its model by id in that cache: run L, ``--model
   Qwen/Qwen3-TTS-12Hz-1.7B-Base --max-tokens 200``, four streams: two ICL
   voice clones (a 3 s 24 kHz reference WAV uploaded as the ``audio``
   field, and a ``ref_text``), one ``x_vector_only_mode=true`` clone and
   one without audio; run M, ``--model
   Qwen/Qwen3-TTS-12Hz-1.7B-VoiceDesign --max-tokens 140`` from the same
   talker without a speaker encoder, two ``instruct`` streams; run N, J's
   configuration from the sesame/csm-1b snapshot (``--max-tokens 1072``:
   every prompt carries the default two-speaker context built from the
   prompt WAVs through the Mimi encoder on the card). Last,
   FunAudioLLM/CosyVoice2-0.5B (the LM in ``model.safetensors`` with its
   text table, ``flow.pt``, ``hift.pt`` under ``generator.``, the full S3
   v2 as ``speech_tokenizer_v2.onnx`` and CAMPPlus as ``campplus.onnx``,
   written by the script's own protobuf writer) is loaded on the card
   through the model's constructor, and run P serves O's configuration
   from it: two voice clones (the 3 s reference WAV uploaded as ``audio``
   and a ``ref_text``), a clone without ``ref_text`` and a request without
   audio (``--max-tokens 280``). Last, GLM-4-Voice-9B: zai-org/glm-4-voice-9b
   in the ChatGLM layout (fused q/k/v with random biases, fused gate/up,
   bf16) at full width but 4 of its 40 layers, loaded through the model's
   LM loader and then dropped; zai-org/glm-4-voice-decoder (``flow.pt``,
   ``hift.pt`` under ``generator.``) and zai-org/glm-4-voice-tokenizer
   (the Whisper-VQ safetensors), each loaded bit-equal through the
   model's loaders; run R serves Q's configuration with those two in the
   cache, so the backbone is random (its repo is absent, as the JAX
   package then serves it) and the stats file must report ``flow``,
   ``hift`` and ``vq_encoder`` loaded. Last, Step-Audio-2-mini:
   stepfun-ai/Step-Audio-2-mini with its LM at full width but 4 of its 28
   layers (q/k/v with random biases, ``lm_head``, bf16) and the full
   32-layer audio encoder and adaptor (``encoder.*``, ``adapter.*``, bf16)
   in two safetensors shards, and ``token2wav/flow.pt`` and
   ``token2wav/hift.pt``: the LM and encoder mappers, then the flow and
   HiFT mappers, load bit-equal on the card; run T serves S's
   configuration from that snapshot (one upload, one text stream): its LM
   does not map at 28 layers, so, as in the JAX package, the backbone and
   the encoder are random and the stats file must report ``flow`` and
   ``hift`` loaded, ``backbone`` and ``encoder`` not. Last, Chatterbox:
   ResembleAI/chatterbox at the published widths (``t3_cfg.safetensors``:
   the T3 in bf16 with its tables, ``speech_head`` and ``cond_enc.*``;
   ``s3gen.safetensors``: the flow, HiFT under ``mel2wav.``, the full S3
   v2 under ``tokenizer.`` and CAMPPlus under ``speaker_encoder.``;
   ``conds.pt``) and resemble-ai/perth (``perth_net_250000.pth.tar``),
   loaded through the model's constructor and the watermarker's loader,
   bit-equal (``conds.pt``'s tensors stay on the host, its decoder prompt
   trimmed to 128 tokens and 256 mel rows); run V serves U's
   configuration from both: two default-voice streams (``conds.pt``
   through the conditioning encoder) and two uploads of the 3 s WAV (S3
   v2 and CAMPPlus on the card in preprocess), every part loaded and the
   daemon reporting the Perth watermark, which every detokenize graph
   replays. Last, Zonos-v0.1: Zyphra/Zonos-v0.1-transformer
   (``model.safetensors``: the 26 x 2048 LM in bf16, the prefix
   conditioner in float32; ``config.json`` with its conditioner list),
   descript/dac_44khz (``model.safetensors``, float32) and
   Zyphra/Zonos-v0.1-speaker-embedding (the ResNet293 base and LDA-128
   ``.pt`` files), each loaded bit-equal through the model's loaders; run
   X serves W's configuration from the three: two uploads of the 3 s WAV
   (the speaker net on the card in preprocess; the daemon's log must name
   no failed extraction) and two text streams, every part loaded. Each of
   L-P must
   report every part
   of its model loaded from the checkpoint (a mapping that fell back to
   random init fails the run), K1
   and K3 launched in graphs as in A, each stream's PCM by the trim rule,
   and each prompt exactly as long as its variant's rows (L's ICL prompts
   hold the reference's 38 frames, M's have no speaker row, N's the
   context, P's clones the reference's 75 S3 v2 tokens, R's uploads their
   38 Whisper-VQ tokens, T's upload its 18 adaptor rows, V's and X's
   uploads as long as their text streams).
7. two cards: where ``torch.cuda.device_count() >= 2``, run DG (A's
   configuration with ``--scheduler-type disaggregation`` (which sets
   ``--enable-disaggregation``) and ``VOX_FUSED_RESUNIT=1``: the
   disaggregation scheduler's LM and detokenizer threads, the LM's
   prefill and decode graphs with K1 and
   K3 on cuda:0, the codec with K2 and every detokenize graph on cuda:1,
   checked graph by graph from the stats file's ``graphs_by_device``) and
   run DP (A's configuration at ``--dp-size 2``: one daemon a card, the
   four streams round robin, both ranks must serve and launch K1 and K3
   only). With one card the launcher must refuse both
   ``--enable-disaggregation`` and ``--dp-size 2`` at start-up: exit
   non-zero within 60 s, name the card count, leave no daemon alive; the
   script prints that the two-card runs were not run, and why.

8. four cards: where ``torch.cuda.device_count() >= 4``, run TP (A's
   configuration at ``--tp-size 4``: the flagship's backbone and KV pool
   split over four ranks, one process a card) and TPG (Q's at ``--tp-size
   4 --weight-quant int8``: GLM-4-Voice-9B quantized whole, split, K5 at
   the shard widths), each held to A's or Q's checks (the trim rule, K1
   and K3 (and K5) on rank 0 once a layer per step, all in graphs) and to
   ``check_tp_run``: every rank replayed every LM step as a graph, with no
   eager call, launched K1 and K3 (and K5) as rank 0 did and nothing else,
   and holds its KV heads only (the pool's bytes / 4); it prints each
   rank's decode probes, the all-reduce's device ms per call at decode and
   prefill rows and each run beside A or Q of this call. With fewer cards
   the launcher must refuse ``--tp-size 4`` at start-up (exit non-zero
   within 60 s, the count named, no daemon or rank process left); the
   script prints that TP and TPG were not run, and why.

The line before the last is a JSON object describing each kernel (at its
largest shape, K6 at Qwen3-TTS's stack and B = 128; launches summed over
the tensor-parallel ranks); the last
line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --kernels-only

runs phases 1-4's attention-kernel checks and K6 only and prints no result
lines.
The script builds and times the port beside it, so a copy of it placed in
another checkout (a parent commit unpacked with ``git archive``) times
that checkout's kernels at this script's shapes.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.parse
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "smoke_out"  # server log and stats (gitignored)

K1_TOL = 2e-2  # bf16 output rounding (2^-8 relative) + f32 sum order
K3_TOL = 2e-2
# relative to max |ref|: f32 sums over 7*C + C products in another order,
# each product in 3xTF32 (hi*hi + hi*lo + lo*hi, ~2^-21 relative), and sinf
# against torch's sin
K2_REL_TOL = 1e-4
# K2 in bf16 against its bf16 plain version, relative to max |ref|: both
# round y, z and the output to bf16 at the same points, so another f32 sum
# order flips a rounding by one bf16 step (2^-7 of the top binade), and a
# flip carried through the chained units can add one more: 2^-6
K2_BF16_REL_TOL = 2.0 ** -6
# K5 against its plain version, relative to max |ref|: both round the f32
# sum, its product with the bf16 scale and the bias sum to bf16 at the same
# points; another f32 sum order flips a rounding by one bf16 step (2^-7 of
# the top binade), and a flipped sum can carry one more through the scale
K5_REL_TOL = 2.0 ** -6
# bf16 weights/activations vs the f32 CPU run (quantized pools: the two
# runs quantize K/V computed in bf16 and in f32, so a few elements round
# to a neighbouring int8 / float8 value)
BACKBONE_REL_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, graph: bool = False) -> float:
    """Mean ms per call of ``iters`` back-to-back calls between two CUDA
    events. Eager calls include the host's cost per call wherever the host
    is slower than the device; ``graph=True`` captures the calls in one CUDA
    graph and times its replay, which is the device's time alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    run, reps = fn, iters
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        run, reps = g.replay, 1
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate_times(plain, kernel, iters: int = 20,
                    graph: bool = False) -> tuple[float, float]:
    """plain, kernel, kernel, plain; mean of the two runs of each."""
    p1 = cuda_time_ms(plain, iters, graph)
    k1 = cuda_time_ms(kernel, iters, graph)
    k2 = cuda_time_ms(kernel, iters, graph)
    p2 = cuda_time_ms(plain, iters, graph)
    return (k1 + k2) / 2, (p1 + p2) / 2


# NVIDIA H100 SXM peaks (data sheet, dense, at 700 W): the least time the
# card could take for a kernel's work is the larger of its bytes (each
# input read once, each output written once) over the memory rate and its
# operations over the peak rate for the type they run in (tensor cores:
# bf16, 8-bit, TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "8bit": 1979e12, "tf32": 495e12}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """bound_ms and what bounds it (bytes or operations)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def result(err: float, ms: float, plain_ms: float, bnd: dict,
           library_ms=None) -> dict:
    """One kernel's entry of the result line (at one shape)."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
            "bound_share": bnd["bound_ms"] / ms, "library_ms": library_ms}


def bound_text(r: dict) -> str:
    lib = r["library_ms"]
    return (f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) bound_share="
            f"{r['bound_share']:.3f} library_ms="
            f"{'none' if lib is None else format(lib, '.4f')}")


# ---------------------------------------------------------------------------
# phase 3: K1
# ---------------------------------------------------------------------------


#: decode variants: name -> (pool element type, layout)
DECODE_VARIANTS = {
    "K1": ("bfloat16", "combined"),
    "K1q int8": ("int8", "combined"),
    "K1q f8_e4m3": ("float8_e4m3fn", "combined"),
    "K4": ("bfloat16", "pair"),
}


#: the (seq_lens, block tables) of each decode batch size and the segment
#: lengths of each K3 length, as first drawn: later checks (other pools,
#: other head layouts) reuse them, so each reads the same KV tokens
_DECODE_ROWS: dict = {}
_K3_LENS: dict = {}


def check_decode(kernels, variant: str, H: int = 16, KH: int = 8,
                 batches=(1, 4, 8, 64), D: int = 128) -> dict:
    """One paged decode kernel against its plain version at a talker's
    shapes (Qwen3's H=16/KH=8 by default; Orpheus's H=24/KH=8, G = 3;
    CSM's H=32/KH=8 at D=64, G = 4), reading the last layer of a 4096-page
    pool. Returns the last batch's result."""
    import torch

    dev = torch.device("cuda")
    dtype_name, layout = DECODE_VARIANTS[variant]
    dtype = getattr(torch, dtype_name)
    L, P, page = 28, 4096, 16
    layer = L - 1  # the far end of the pool: offsets past 2^31 elements
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    kv_scales = None
    if layout == "pair":
        shape = (L, KH, P, page, D)
        pools = [torch.empty(shape, dtype=dtype, device=dev) for _ in "kv"]
        for pl in pools:
            pl[layer].normal_(generator=g)
    else:
        pool = torch.empty((L, P, page, 2 * KH, D), dtype=dtype, device=dev)
        if dtype == torch.int8:
            pool[layer] = torch.randint(-127, 128, pool.shape[1:],
                                        generator=g, device=dev,
                                        dtype=torch.int8)
            kv_scales = (4.0 / 127.0, 4.0 / 127.0)
        elif dtype == torch.float8_e4m3fn:
            pool[layer] = torch.randn(pool.shape[1:], generator=g,
                                      device=dev).to(dtype)
            kv_scales = (1.0, 1.0)
        else:
            pool[layer].normal_(generator=g)
        pools = [pool]
    elem = torch.empty((), dtype=dtype).element_size()
    # the split workspace for every shape below, as a worker holds one
    scratch = kernels.DecodeScratch(dev, 64, H, KH, D, -(-1000 // page))
    if layout == "pair":
        def kernel(q, tables, seq):
            return kernels.paged_decode_attention_pair(q, *pools, layer,
                                                       tables, seq,
                                                       scratch=scratch)

        def plain(q, tables, seq):
            return kernels.paged_decode_attention_pair_plain(
                q, *pools, layer, tables, seq)
    else:
        def kernel(q, tables, seq):
            return kernels.paged_decode_attention(q, pools[0], layer, tables,
                                                  seq, kv_scales=kv_scales,
                                                  scratch=scratch)

        def plain(q, tables, seq):
            return kernels.paged_decode_attention_plain(
                q, pools[0], layer, tables, seq, kv_scales=kv_scales)

    worst, res = 0.0, {}
    rng = torch.Generator().manual_seed(2)
    for B in batches:
        if B not in _DECODE_ROWS:
            if B == 4:  # the served batch: 42-token prompts, <= 100 frames
                seq = torch.randint(40, 121, (B,), generator=rng)
            else:
                seq = torch.randint(1, 1001, (B,), generator=rng)
            if B > 1:
                seq[B // 2] = 1  # padded row: seq_len 1 on scratch page 0
            maxp = int((seq.max() + page - 1) // page)
            perm = torch.randperm(P - 1, generator=rng)[: B * maxp] + 1
            tables = perm.reshape(B, maxp).to(torch.int32)
            if B > 1:
                tables[B // 2] = 0
            _DECODE_ROWS[B] = (seq, tables)
        seq, tables = (t.clone() for t in _DECODE_ROWS[B])
        q = torch.randn((B, H, D), generator=rng).to(torch.bfloat16)
        q, tables, seq = q.to(dev), tables.to(dev), seq.to(torch.int32).to(dev)
        out = kernel(q, tables, seq)
        ref = plain(q, tables, seq)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not torch.isfinite(out.float()).all() or err > K1_TOL:
            raise AssertionError(f"{variant} B={B}: max_abs_err {err} > "
                                 f"{K1_TOL}")
        ms, plain_ms = alternate_times(lambda: plain(q, tables, seq),
                                       lambda: kernel(q, tables, seq),
                                       graph=True)
        eager_ms = cuda_time_ms(lambda: kernel(q, tables, seq))
        worst = max(worst, err)
        # bytes the kernel must move: every live token's K and V rows, q,
        # out, the block tables and lengths; 2 flops per K and V element
        # per query head
        tokens = int(seq.sum())
        kv_bytes = tokens * 2 * KH * D * elem
        nbytes = kv_bytes + 2 * B * H * D * 2 + tables.numel() * 4 + B * 4
        bnd = bound(nbytes, 4.0 * tokens * H * D,
                    "bf16" if elem == 2 else "8bit")
        r = result(worst, ms, plain_ms, bnd)
        log(f"{variant} {layout} {dtype_name} pool H={H} KH={KH} D={D} B={B} "
            f"max_seq={int(seq.max())} tokens={tokens} "
            f"max_abs_err={err:.3e} (tol {K1_TOL}) kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} eager_call_ms={eager_ms:.4f} "
            f"kv_read_GB/s="
            f"{kv_bytes / (ms * 1e-3) / 1e9:.0f} ({elem} B/elem) "
            f"{bound_text(r)}")
        res = r
    del pools
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4: K3 and the small backbone
# ---------------------------------------------------------------------------


def check_k3(kernels, H: int = 16, KH: int = 8,
             shapes=((64, 1), (168, 4), (256, 3), (1024, 5)),
             D: int = 128) -> dict:
    """K3 against its plain version and SDPA at (T, segments) shapes, for
    Qwen3's H=16/KH=8 by default (Orpheus: H=24/KH=8; CSM: H=32/KH=8 at
    D=64). Returns the last shape's result."""
    import torch

    dev = torch.device("cuda")
    rng = torch.Generator().manual_seed(3)
    worst, res = 0.0, {}
    for T, nseg in shapes:
        if T == 168:  # the served prefill: four 42-token prompts
            lens = [42] * 4
        elif T in _K3_LENS:
            lens = _K3_LENS[T]
        else:
            # nseg random positive spans, then a padded tail (seg -1)
            valid = T - int(torch.randint(0, T // 8 + 1, (1,),
                                          generator=rng))
            cuts = sorted((torch.randperm(valid - 1, generator=rng)
                           [: nseg - 1] + 1).tolist())
            lens = [b - a for a, b in zip([0] + cuts, cuts + [valid])]
        _K3_LENS[T] = lens
        seg = torch.full((T,), -1, dtype=torch.int32)
        c = 0
        for i, n in enumerate(lens):
            seg[c:c + n] = i
            c += n
        q = torch.randn((T, H, D), generator=rng).to(torch.bfloat16).to(dev)
        k = torch.randn((T, KH, D), generator=rng).to(torch.bfloat16).to(dev)
        v = torch.randn((T, KH, D), generator=rng).to(torch.bfloat16).to(dev)
        seg = seg.to(dev)
        out = kernels.ragged_prefill_attention(q, k, v, seg)
        ref = kernels.ragged_prefill_attention_plain(q, k, v, seg)
        torch.cuda.synchronize()
        valid = seg >= 0
        err = (out[valid].float() - ref[valid].float()).abs().max().item()
        if not torch.isfinite(out.float()).all() or err > K3_TOL:
            raise AssertionError(f"K3 T={T}: max_abs_err {err} > {K3_TOL}")
        ms, plain_ms = alternate_times(
            lambda: kernels.ragged_prefill_attention_plain(q, k, v, seg),
            lambda: kernels.ragged_prefill_attention(q, k, v, seg),
            graph=True)
        eager_ms = cuda_time_ms(
            lambda: kernels.ragged_prefill_attention(q, k, v, seg))
        lib_ms, lib_err = sdpa_time(q, k, v, seg, ref)
        worst = max(worst, err)
        # causal pairs x (QK^T + PV) x heads x head dim
        flops = sum(n * (n + 1) // 2 for n in lens) * 4 * H * D
        nbytes = 2 * T * H * D * 2 + 2 * T * KH * D * 2 + T * 4
        r = result(worst, ms, plain_ms, bound(nbytes, flops, "bf16"),
                   lib_ms)
        log(f"K3 ragged_prefill_attention H={H} KH={KH} D={D} "
            f"tile={kernels.plan_prefill_tiles(T, H, KH)} T={T} "
            f"segments={lens} "
            f"valid={int(valid.sum())} max_abs_err={err:.3e} (tol {K3_TOL}) "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} eager_call_ms="
            f"{eager_ms:.4f} TFLOP/s={flops / (ms * 1e-3) / 1e12:.2f} "
            f"{bound_text(r)} "
            f"(sdpa max_abs_err {lib_err:.3e})")
        res = r
    return res


def sdpa_time(q, k, v, seg, ref) -> tuple[float, float]:
    """The library yardstick of K3: one scaled_dot_product_attention call
    with the block-diagonal causal boolean mask and grouped KV heads, the
    mask and layouts made outside the timed region, timed twice as K3 is
    (graph replay). Returns its ms and its error on the valid rows against
    the plain version."""
    import torch
    import torch.nn.functional as F

    T, H, _ = q.shape
    KH = k.shape[1]
    idx = torch.arange(T, device=q.device)
    mask = ((seg[:, None] == seg[None, :]) & (seg[:, None] >= 0)
            & (idx[:, None] >= idx[None, :]))
    qh = q.transpose(0, 1).unsqueeze(0)
    kh = k.transpose(0, 1).unsqueeze(0)
    vh = v.transpose(0, 1).unsqueeze(0)

    def call():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              enable_gqa=True)

    out = call()[0].transpose(0, 1)
    valid = seg >= 0
    err = (out[valid].float() - ref[valid].float()).abs().max().item()
    t1 = cuda_time_ms(call, graph=True)
    t2 = cuda_time_ms(call, graph=True)
    return (t1 + t2) / 2, err


#: the small backbone's head layouts: (query heads, KV heads, head dim,
#: q/k norms, Llama-3.1 rope at theta 5e5 (else theta 1e6))
BACKBONE_HEADS = {"qwen3": (4, 2, 128, True, False),
                  "orpheus": (6, 2, 128, False, True),
                  "csm": (8, 2, 64, False, True)}


def check_backbone(kv: str = "combined", heads: str = "qwen3",
                   weight_quant: str = "none") -> None:
    """Small talker backbone: card (bf16, kernels) vs CPU (f32, plain), over
    the combined full-precision pool ("combined"), an int8 or f8_e4m3 one,
    or the head-major pair ("pair"). ``heads`` (``BACKBONE_HEADS``): Qwen3's
    4 query heads over 2 with q/k norms, Orpheus's GQA group of 3 (6 over
    2) or CSM's group of 4 at head dim 64 (8 over 2), both with Llama-3.1
    rope scaling. ``weight_quant="int8"``: the matmul weights quantized
    once on the CPU in float32 (``quantize_backbone_params``) and packed
    (``pack_backbone_params``), the card through K5 (which must launch 4
    times per layer and step: q/k/v and gate/up grouped) against the CPU
    through its plain version."""
    import torch

    from vox_serve_tpu_torch.models.backbone import (BackboneConfig,
                                                     backbone_forward,
                                                     init_backbone_params,
                                                     pack_backbone_params,
                                                     quantize_backbone_params)
    from vox_serve_tpu_torch.ops import kernels
    from vox_serve_tpu_torch.ops.attention import AttnMetadata
    from vox_serve_tpu_torch.ops.kv_cache import KVCacheConfig, alloc_kv_pages
    from vox_serve_tpu_torch.params import tree_to_torch

    H, KH, D, qk_norm, llama31 = BACKBONE_HEADS[heads]
    cfg = BackboneConfig(vocab_size=64, hidden_size=256, num_layers=2,
                         num_heads=H, num_kv_heads=KH, head_dim=D,
                         intermediate_size=512, qk_norm=qk_norm,
                         rope_theta=5e5 if llama31 else 1e6,
                         llama31_rope_scaling=llama31, dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    params = init_backbone_params(cfg, g, "cpu")
    if weight_quant == "int8":
        params = pack_backbone_params(quantize_backbone_params(params))
    lens, page, P = (37, 20), 16, 16
    T = sum(lens)
    x0 = torch.randn((T, 256), generator=g)
    xs = [torch.randn((len(lens), 256), generator=g) for _ in range(3)]
    pages = [[1, 2, 3, 4], [5, 6, 7, 8]]

    def run(device, dtype):
        import dataclasses

        c = dataclasses.replace(cfg, dtype=dtype)
        p = tree_to_torch(params, device, dtype)
        kvc = KVCacheConfig(2, P, page, KH, D, dtype=dtype,
                            combined=kv != "pair",
                            quant=kv if kv in ("int8", "f8_e4m3") else "none",
                            k_amax=4.0, v_amax=4.0)
        pools = alloc_kv_pages(kvc, device)
        seg = torch.cat([torch.full((n,), i) for i, n in enumerate(lens)])
        pos = torch.cat([torch.arange(n) for n in lens])
        pid = torch.cat([torch.tensor(pages[i])[torch.arange(n) // page]
                         for i, n in enumerate(lens)])
        off = pos % page

        def t(a):
            return a.to(torch.int32).to(device)

        meta = AttnMetadata(True, t(pid), t(off), segment_ids=t(seg),
                            q_positions=t(pos))
        outs = [backbone_forward(p, c, x0.to(device, dtype), t(pos), meta,
                                 *pools, kvc.kv_scales)]
        for s, x in enumerate(xs):
            cur = torch.tensor([n + s for n in lens])
            meta = AttnMetadata(
                False, t(torch.tensor([pages[i][int(cur[i]) // page]
                                       for i in range(len(lens))])),
                t(cur % page), block_tables=t(torch.tensor(pages)),
                seq_lens=t(cur + 1))
            outs.append(backbone_forward(p, c, x.to(device, dtype), t(cur),
                                         meta, *pools, kvc.kv_scales))
        return [o.float().cpu() for o in outs]

    ref = run("cpu", torch.float32)
    k5 = kernels.w8a16_linear.launches
    got = run("cuda", torch.bfloat16)
    torch.cuda.synchronize()
    k5 = kernels.w8a16_linear.launches - k5
    want = K5_PER_LAYER * cfg.num_layers * 4 if weight_quant == "int8" \
        else 0
    if k5 != want:
        raise AssertionError(f"backbone ({weight_quant} weights): K5 "
                             f"launched {k5} times, expected {want}")
    rel = max(((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(got, ref))
    if rel > BACKBONE_REL_TOL:
        raise AssertionError(f"backbone ({kv} KV, {weight_quant} weights) "
                             f"on card vs CPU: rel err {rel}")
    layout = (f"{H}/{KH} heads, D={D}"
              + (", Llama-3.1 rope" if llama31 else ""))
    quant = (f", int8 weights: K5 x {k5}" if weight_quant == "int8"
             else "")
    log(f"backbone (2x256, {layout}, prefill {list(lens)} + 3 decode steps, "
        f"{kv} KV{quant}) card bf16 kernels vs CPU f32 plain: max rel err "
        f"{rel:.3e} (tol {BACKBONE_REL_TOL})")


# ---------------------------------------------------------------------------
# K6: the depth layer's kernels alone
# ---------------------------------------------------------------------------

#: the depth stacks K6 serves: (hidden, H, KH, intermediate, max_seq, q/k
#: norm, rope theta), and the batches of their decode buckets
K6_SHAPES = {"qwen3": (1024, 16, 8, 3072, 17, True, 1e6),
             "csm": (1024, 8, 2, 8192, 33, False, 5e5)}
K6_BATCHES = (1, 16, 128)


def check_k6(kernels) -> dict:
    """Each K6 kernel against its plain version at the served depth
    stacks' shapes, one new token a row at ``K6_BATCHES`` rows, attention
    at the middle of a frame (position max_seq // 2): max abs error and
    CUDA-graph times of kernel and plain version, beside the kernel's byte
    bound (each input read once, each output written once; its operations
    are far below the tensor cores' line). Attention's library yardstick
    is SDPA with the causal mask over the same bf16 cache. Returns each
    kernel's entry of the result line by its name: its numbers at
    Qwen3-TTS's stack and B = 128 (the served cell's decode bucket), with
    its largest error over every stack and batch."""
    import torch
    import torch.nn.functional as F

    dev, bf = torch.device("cuda"), torch.bfloat16
    out = {}
    for name, (C, H, KH, I, S, qk, theta) in K6_SHAPES.items():
        D, pos = 128, S // 2
        for B in K6_BATCHES:
            g = torch.Generator(device=dev).manual_seed(B)

            def rnd(*shape):
                return torch.randn(shape, generator=g, device=dev).to(bf)

            h, r, w = rnd(B, 1, C), rnd(B, 1, C), rnd(C) * 0.1 + 1
            qkv = rnd(B, 1, (H + 2 * KH) * D)
            nw = (rnd(D) * 0.1 + 1) if qk else None
            kc, vc = rnd(B, S, KH, D), rnd(B, S, KH, D)
            q, gu = rnd(B, 1, H, D), rnd(B, 2 * I)
            mask = (torch.arange(S, device=dev) <= pos)[None]
            qt, kt, vt = (q.transpose(1, 2), kc.transpose(1, 2),
                          vc.transpose(1, 2))
            cases = {
                "K6a depth_add_rms_norm": (
                    lambda: kernels.depth_add_rms_norm(h, r, w),
                    lambda: kernels.depth_add_rms_norm_plain(h, r, w),
                    None, 4 * B * C * 2 + C * 2),
                "K6b depth_qkv_rope": (
                    lambda: kernels.depth_qkv_rope(qkv, nw, nw, kc, vc, pos,
                                                   theta),
                    lambda: kernels.depth_qkv_rope_plain(qkv, nw, nw, kc, vc,
                                                         pos, theta),
                    None, B * D * 2 * (2 * H + 4 * KH) + 4 * D),
                "K6c depth_attention": (
                    lambda: kernels.depth_attention(q, kc, vc, pos),
                    lambda: kernels.depth_attention_plain(q, kc, vc, pos),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True),
                    2 * B * H * D * 2 + 2 * B * (pos + 1) * KH * D * 2),
                "K6d depth_silu_mul": (
                    lambda: kernels.depth_silu_mul(gu),
                    lambda: kernels.depth_silu_mul_plain(gu),
                    None, 3 * B * I * 2),
            }
            for kname, (kern, plain, lib, nbytes) in cases.items():
                got, want = kern(), plain()
                if isinstance(got, tuple):
                    got, want = got[1], want[1]
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got.float()).all() or \
                        err > 2.0 ** -6 * max(want.float().abs().max()
                                              .item(), 1.0):
                    raise AssertionError(f"{kname} {name} B={B}: max abs "
                                         f"err {err}")
                ms, plain_ms = alternate_times(plain, kern, graph=True)
                lib_ms = (None if lib is None else
                          (cuda_time_ms(lib, graph=True)
                           + cuda_time_ms(lib, graph=True)) / 2)
                res = result(err, ms, plain_ms, bound(nbytes, 0, "bf16"),
                             lib_ms)
                out[name, kname, B] = res
                log(f"{kname} {name} B={B} pos={pos}: max_abs_err "
                    f"{err:.3e} kernel_ms={ms:.4f} plain_ms="
                    f"{plain_ms:.4f} {bound_text(res)}")
    served = {}
    for kname in {k for _, k, _ in out}:
        worst = max(r["max_abs_err"] for (_, k, _), r in out.items()
                    if k == kname)
        served[kname.split()[1]] = {**out["qwen3", kname, 128],
                                    "max_abs_err": worst}
    return served


# ---------------------------------------------------------------------------
# tensor parallelism on one card: the ranks one after another
# ---------------------------------------------------------------------------

#: the TP phase's backbones at full width (4 of their layers): the
#: flagship's Qwen3 talker (16 / 8 heads: 4 / 2 a rank at tp 4) and
#: GLM-4-Voice-9B's (32 / 2 heads: 8 / 1 a rank at tp 4, each KV head on
#: two ranks)
TP_BACKBONES = {
    "qwen3-tts": dict(hidden_size=2048, num_heads=16, num_kv_heads=8,
                      head_dim=128, intermediate_size=6144, qk_norm=True,
                      rope_theta=1e6),
    "glm": dict(hidden_size=4096, num_heads=32, num_kv_heads=2,
                head_dim=128, intermediate_size=13696, qkv_bias=True,
                rope_dim=64, rope_interleaved=True, rms_eps=1.5625e-07),
}
TP_LAYERS = 4
#: the split backbone in bf16 against the whole one in bf16, relative to
#: the whole one's peak: each o and down output is rounded to bf16 per
#: rank and the partial sums add in bf16 (one rounding more per layer and
#: sublayer than the whole matmul's), and the residual stream carries it
#: through 4 layers and the final norm
TP_REL_TOL = 5e-2


def check_tp_backbone(kernels) -> list:
    """A tensor-parallel backbone's ranks run one after another on the one
    card, the partial sums added in place of each all-reduce
    (``backbone_forward_shards``), at tp 2 and 4, against the whole
    backbone on the same card and inputs: a T = 168 prefill (four 42-token
    prompts) and three B = 4 decode steps, in bf16 and at int8 weights
    (the whole tree quantized, then split, then each shard packed, as the
    worker does). Every rank's K1 / K3 (and K5) launches counted; each
    rank's pool held against its KV heads' rows of the whole pool. Returns
    one result per (backbone, weights, tp)."""
    import torch

    from vox_serve_tpu_torch.models.backbone import (
        BackboneConfig, backbone_forward, backbone_forward_shards,
        init_backbone_params, pack_backbone_params, quantize_backbone_params,
        seeded_generator, w8a16_groups)
    from vox_serve_tpu_torch.ops.attention import AttnMetadata
    from vox_serve_tpu_torch.ops.kv_cache import KVCacheConfig, alloc_kv_pages
    from vox_serve_tpu_torch.parallel import shard_params
    from vox_serve_tpu_torch.parallel.sharding import (kv_heads_of,
                                                       shard_config)

    dev = torch.device("cuda")
    lens, page, P, B, steps = [42] * 4, 16, 64, 4, 3
    T = sum(lens)
    pages = [list(range(1 + 8 * i, 9 + 8 * i)) for i in range(B)]

    def t(a):
        return torch.as_tensor(a, dtype=torch.int32).to(dev)

    seg = torch.cat([torch.full((n,), i) for i, n in enumerate(lens)])
    pos = torch.cat([torch.arange(n) for n in lens])
    pid = torch.cat([torch.tensor(pages[i])[torch.arange(n) // page]
                     for i, n in enumerate(lens)])
    out = []
    for name, widths in TP_BACKBONES.items():
        cfg = BackboneConfig(vocab_size=64, num_layers=TP_LAYERS, **widths,
                             dtype=torch.bfloat16)
        g = seeded_generator(dev, 11)
        whole = init_backbone_params(cfg, g, dev)
        for part in whole["layers"].values():
            for leaf in (part.values() if isinstance(part, dict) else []):
                if isinstance(leaf, dict) and "b" in leaf:
                    leaf["b"].copy_(0.1 * torch.randn(
                        leaf["b"].shape, generator=g, device=dev))
        xs = [torch.randn((T, cfg.hidden_size), generator=g, device=dev)
              .to(torch.bfloat16)] + [
            torch.randn((B, cfg.hidden_size), generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(steps)]
        D, KH = cfg.head_dim, cfg.num_kv_heads
        for wq in ("none", "int8"):
            tree = quantize_backbone_params(whole) if wq == "int8" else whole
            runs = {}
            for tp in (1, 2, 4):
                shards = [shard_params(tree, r, tp, KH) for r in range(tp)]
                if wq == "int8":
                    shards = [pack_backbone_params(s) for s in shards]
                lcfg = shard_config(cfg, tp)
                kvc = KVCacheConfig(TP_LAYERS, P, page, lcfg.num_kv_heads, D,
                                    dtype=torch.bfloat16, combined=True)
                pools = [alloc_kv_pages(kvc, dev) for _ in shards]
                scratch = [(kernels.DecodeScratch(
                    dev, B, lcfg.num_heads, lcfg.num_kv_heads, D, 8, page),
                    kernels.W8A16Scratch(dev, w8a16_groups(s))
                    if wq == "int8" else None) for s in shards]
                counts0 = kernels.launch_counts()
                hs = []
                for s, x in enumerate(xs):
                    if s == 0:
                        metas = [AttnMetadata(True, t(pid), t(pos % page),
                                              segment_ids=t(seg),
                                              q_positions=t(pos),
                                              linear_scratch=ws)
                                 for _, ws in scratch]
                        xpos = t(pos)
                    else:
                        cur = torch.tensor([n + s - 1 for n in lens])
                        metas = [AttnMetadata(
                            False, t([pages[i][int(c) // page]
                                      for i, c in enumerate(cur)]),
                            t(cur % page), block_tables=t(pages),
                            seq_lens=t(cur + 1), decode_scratch=ds,
                            linear_scratch=ws) for ds, ws in scratch]
                        xpos = t(cur)
                    if tp == 1:
                        hs.append(backbone_forward(shards[0], cfg, x, xpos,
                                                   metas[0], *pools[0]))
                    else:
                        hs.append(backbone_forward_shards(
                            shards, cfg, x, xpos, metas, pools))
                torch.cuda.synchronize()
                counts = {k: v - counts0[k]
                          for k, v in kernels.launch_counts().items()}
                want = {K3: tp * TP_LAYERS, K1: tp * TP_LAYERS * steps}
                if wq == "int8":
                    want[K5] = tp * K5_PER_LAYER * TP_LAYERS * (1 + steps)
                got = {k: n for k, n in counts.items() if n}
                if got != want:
                    raise AssertionError(f"TP {name} {wq} tp={tp}: kernel "
                                         f"launches {got}, expected {want}")
                runs[tp] = (hs, pools)
            ref, ref_pools = runs[1]
            for tp in (2, 4):
                hs, pools = runs[tp]
                rel = max(((a.float() - b.float()).abs().max()
                           / b.float().abs().max()).item()
                          for a, b in zip(hs, ref))
                finite = all(torch.isfinite(h.float()).all() for h in hs)
                pool_rel = 0.0
                whole_pool = ref_pools[0][0].float()
                for r, (pool, _) in enumerate(pools):
                    rows = [2 * h + i for h in kv_heads_of(r, cfg.num_heads,
                                                           KH, tp)
                            for i in (0, 1)]
                    want_pool = whole_pool[:, :, :, rows]
                    pool_rel = max(pool_rel, (
                        (pool.float() - want_pool).abs().max()
                        / want_pool.abs().max()).item())
                if not finite or rel > TP_REL_TOL or pool_rel > TP_REL_TOL:
                    raise AssertionError(
                        f"TP {name} {wq} tp={tp}: split vs whole rel err "
                        f"{rel:.3e} (pools {pool_rel:.3e}, finite {finite})"
                        f" > {TP_REL_TOL}")
                lcfg = shard_config(cfg, tp)
                log(f"TP {name} backbone (full width, {TP_LAYERS} of its "
                    f"layers, {wq} weights) tp={tp}: {lcfg.num_heads}/"
                    f"{lcfg.num_kv_heads} heads and MLP width "
                    f"{lcfg.intermediate_size} a rank, the ranks one after "
                    f"another on the card, partial sums added: prefill "
                    f"T={T} + {steps} decode steps at B={B} vs the whole "
                    f"backbone: max rel err {rel:.3e}, each rank's pool vs "
                    f"its KV heads' rows {pool_rel:.3e} (tol {TP_REL_TOL})")
                out.append({"backbone": name, "weights": wq, "tp": tp,
                            "rel_err": rel, "pool_rel_err": pool_rel})
            del runs, ref, ref_pools, tree
        del whole
        torch.cuda.empty_cache()
    return out


#: K5's widths: model -> (hidden, query heads, KV heads, head dim, MLP
#: width, q/k/v bias); each times the seven linears of one layer
K5_WIDTHS = {"qwen3-tts": (2048, 16, 8, 128, 6144, False),
             "orpheus": (3072, 24, 8, 128, 8192, False),
             "glm": (4096, 32, 2, 128, 13696, True),
             "step": (3584, 28, 4, 128, 18944, True),
             "chatterbox": (1024, 16, 16, 64, 4096, False),
             # one rank's linears at --tp-size 4: q/k/v and gate/up split
             # by columns, o and down by rows (GLM's 13,696 / 4 = 3,424
             # features, not a whole number of 64-wide units)
             "qwen3-tts tp4": (2048, 4, 2, 128, 1536, False),
             "glm tp4": (4096, 8, 1, 128, 3424, True)}
#: rows K5 is timed at: decode batches (1, 4; 32, the smallest batched
#: decode past 16 rows; 64) and prefill (168 = the served prefill of four
#: 42-token prompts, 1024 the largest bucket)
K5_ROWS = (1, 4, 32, 64, 168, 1024)
#: the library yardstick is timed up to this many rows: its CUDA kernel
#: takes up to ~0.5 s a group at 1024
K5_LIB_ROWS = 168
#: the odd shape (K, N) that exercises every tail, at these rows
K5_ODD = ((200, 300), (1, 4, 17, 168))
#: a layer's K5 launches: its linears by position in ``k5_layer``
K5_LAUNCHES = ((0, 1, 2), (3,), (4, 5), (6,))


def k5_layer(dev, width: str, seed: int) -> list:
    """The seven linears of one layer at ``width`` (``K5_WIDTHS``): each
    a dict with the bf16 weight it was quantized from (``w``), its int8
    values (``w_q``, for the library yardstick), the packed leaf as the
    backbone holds it (``leaf``: ``w_p``, ``w_s``, ``b``) and its (K, N),
    drawn on the card from ``seed``."""
    import torch

    from vox_serve_tpu_torch.models.backbone import quantize_linear_params
    from vox_serve_tpu_torch.ops.kernels import pack_w8a16

    Hs, H, KH, D, inter, bias = K5_WIDTHS[width]
    shapes = [(Hs, H * D, bias), (Hs, KH * D, bias), (Hs, KH * D, bias),
              (H * D, Hs, False), (Hs, inter, False), (Hs, inter, False),
              (inter, Hs, False)]
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for K, N, b in shapes:
        w = (torch.randn((K, N), generator=g, device=dev)
             * K ** -0.5).to(torch.bfloat16)
        leaf = {"w": w}
        if b:
            leaf["b"] = (torch.randn((N,), generator=g, device=dev)
                         * 0.1).to(torch.bfloat16)
        q = quantize_linear_params(leaf)
        packed = {"w_p": pack_w8a16(q["w_q"]), "w_s": q["w_s"]}
        if b:
            packed["b"] = q["b"]
        out.append({"w": w, "w_q": q["w_q"], "leaf": packed, "K": K,
                    "N": N})
    return out


def k5_groups(layer: list) -> list:
    """The (K, output widths) of the layer's four K5 launches."""
    return [(layer[ix[0]]["K"], tuple(layer[i]["N"] for i in ix))
            for ix in K5_LAUNCHES]


def k5_group(kernels, layer: list, M: int, scratch, seed: int,
             lib: bool = True) -> dict:
    """Time the seven linears of ``layer`` at M rows as one group: K5's
    four launches (q/k/v and gate/up grouped, as the backbone makes them),
    its plain version, bf16 ``x @ w (+ b)`` of the weights they were
    quantized from (the path int8 replaces) and, where ``lib`` and the
    card's PyTorch has a CUDA kernel for it, ``torch._weight_int8pack_mm``
    (the library yardstick, int8 weights as (N, K), transposed outside the
    timing; it takes no bias). Each output is held against the plain
    version. Returns the group's result (``library_ms`` None where not
    timed)."""
    import torch

    dev = layer[0]["w"].device
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = {K: torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
          for K in {lin["K"] for lin in layer}}
    leaves = [(lin["leaf"]["w_p"], lin["leaf"]["w_s"], lin["leaf"].get("b"))
              for lin in layer]
    launches = [(xs[layer[ix[0]]["K"]], [leaves[i] for i in ix])
                for ix in K5_LAUNCHES]
    plain = [(xs[lin["K"]], *leaf) for lin, leaf in zip(layer, leaves)]
    worst = 0.0
    outs = [y for x, lv in launches
            for y in kernels.w8a16_linear_group(x, lv, scratch)]
    for a, out in zip(plain, outs):
        ref = kernels.w8a16_linear_plain(*a)
        torch.cuda.synchronize()
        rel = ((out.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        if not torch.isfinite(out.float()).all() or rel > K5_REL_TOL:
            raise AssertionError(f"K5 M={M} K={a[0].shape[1]} N="
                                 f"{a[2].shape[0]}: rel err {rel} > "
                                 f"{K5_REL_TOL}")
        worst = max(worst, (out.float() - ref.float()).abs().max().item())
    ms, plain_ms = alternate_times(
        lambda: [kernels.w8a16_linear_plain(*a) for a in plain],
        lambda: [kernels.w8a16_linear_group(x, lv, scratch)
                 for x, lv in launches],
        iters=10, graph=True)

    def bf16_group():
        for lin, a in zip(layer, plain):
            y = a[0] @ lin["w"]
            if a[3] is not None:
                y = y + a[3]

    bf16_ms = (cuda_time_ms(bf16_group, 10, True)
               + cuda_time_ms(bf16_group, 10, True)) / 2
    lib_ms = None
    if lib and torch._C._dispatch_has_kernel_for_dispatch_key(
            "aten::_weight_int8pack_mm", "CUDA"):
        packed = [(xs[lin["K"]], lin["w_q"].t().contiguous(),
                   lin["leaf"]["w_s"].to(torch.bfloat16)) for lin in layer]

        def lib_group():
            for x, qt, sc in packed:
                torch._weight_int8pack_mm(x, qt, sc)

        lib_ms = (cuda_time_ms(lib_group, 10, True)
                  + cuda_time_ms(lib_group, 10, True)) / 2
    # each launch reads its x once; every weight, scale, bias and output once
    nbytes = sum(x.numel() * 2 for x, _ in launches) + sum(
        lin["K"] * lin["N"] + lin["N"] * 4 + M * lin["N"] * 2
        + (lin["N"] * 2 if "b" in lin["leaf"] else 0) for lin in layer)
    flops = sum(2 * M * lin["K"] * lin["N"] for lin in layer)
    r = result(worst, ms, plain_ms, bound(nbytes, flops, "bf16"), lib_ms)
    r["bf16_ms"] = bf16_ms
    return r


def check_k5(kernels) -> dict:
    """K5 against its plain version for the seven linears of one layer
    (four launches) at each ``K5_WIDTHS`` width and ``K5_ROWS`` row count,
    with CUDA-graph times of K5, the plain version, bf16 matmuls of the
    unquantized weights and the library yardstick (up to ``K5_LIB_ROWS``
    rows), and the group's bound; then the odd shape's tails, alone and
    grouped. Returns the Orpheus group at 4 rows (run Y's decode batch)
    with the worst error over every shape."""
    import torch

    dev = torch.device("cuda")
    worst, served = 0.0, None
    has_lib = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    for wi, width in enumerate(K5_WIDTHS):
        layer = k5_layer(dev, width, 50 + wi)
        groups = k5_groups(layer)
        scratch = kernels.W8A16Scratch(dev, groups)
        for M in K5_ROWS:
            r = k5_group(kernels, layer, M, scratch, 70 + M,
                         lib=M <= K5_LIB_ROWS)
            worst = max(worst, r["max_abs_err"])
            lib = r["library_ms"]
            no_lib = ("not timed" if has_lib and M > K5_LIB_ROWS
                      else "none")
            plans = ", ".join(
                "bm {} x {} splits {}".format(*[
                    kernels.plan_w8a16(M, K, ns)[i] for i in (0, 1, 3)])
                for K, ns in groups)
            log(f"K5 w8a16_linear {width} one layer's 7 linears in 4 "
                f"launches M={M} ({plans}): max_abs_err "
                f"{r['max_abs_err']:.3e} (rel tol {K5_REL_TOL}) "
                f"kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
                f"bf16_matmul_ms={r['bf16_ms']:.4f} weight_int8pack_mm_ms="
                f"{no_lib if lib is None else format(lib, '.4f')} "
                f"{bound_text(r)}")
            if width == "orpheus" and M == 4:
                served = r
        del layer, scratch
        torch.cuda.empty_cache()
    (K, N), rows = K5_ODD
    g = torch.Generator(device=dev).manual_seed(9)
    from vox_serve_tpu_torch.models.backbone import quantize_linear_params

    leaf = quantize_linear_params(
        {"w": torch.randn((2, K, N), generator=g, device=dev)})
    w_p = kernels.pack_w8a16(leaf["w_q"])
    b = torch.randn((N,), generator=g, device=dev).to(torch.bfloat16)
    one = (w_p[1], leaf["w_s"][1], b)  # layer 1 of a stack, with a bias
    group = [one, (w_p[0], leaf["w_s"][0], None), one]
    for M in rows:
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        outs = [kernels.w8a16_linear(x, *one),
                *kernels.w8a16_linear_group(x, group)]
        errs = []
        for out, lv in zip(outs, [one, *group]):
            ref = kernels.w8a16_linear_plain(x, *lv)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            if not torch.isfinite(out.float()).all() or rel > K5_REL_TOL:
                raise AssertionError(f"K5 odd shape K={K} N={N} M={M}: rel "
                                     f"err {rel} > {K5_REL_TOL}")
            worst = max(worst, err)
            errs.append(rel)
        log(f"K5 odd shape K={K} N={N} M={M} (layer 1 of a stack, bias; "
            f"alone and as a group of three, padded to {tuple(w_p.shape[1:3])}"
            f" units): max rel err {max(errs):.3e}")
    return {**served, "max_abs_err": worst}


#: K2's decoder blocks at one detokenize of 10 frames: (C, T)
K2_BLOCKS = ((768, 320), (384, 1600), (192, 6400), (96, 19200))


def check_k2(dtype_name: str = "float32") -> dict:
    """K2 against its plain version at the decoder blocks of one detokenize
    of 4 streams x 10 frames and of one stream: whole (zero halos) and as
    two streamed chunks with caches. float32: the plain chain of three
    _residual_units with TF32 off, each multiply-add on the card three TF32
    products; bfloat16: the Pallas kernel's bf16 rounding points, bf16
    parameters as the codec serves them at codec_dtype bfloat16, one bf16
    product per multiply-add. Returns the B=4 errors and four-block times."""
    import torch

    from vox_serve_tpu_torch.codecs.layers import init_conv1d
    from vox_serve_tpu_torch.ops import resunit

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    bf16 = dtype == torch.bfloat16
    name, tol = ("K2-bf16", K2_BF16_REL_TOL) if bf16 else ("K2", K2_REL_TOL)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    res = {}
    for B in (4, 1):
        worst_abs = worst_rel = 0.0
        ms_sum = plain_sum = flops_sum = 0.0
        for C, T in K2_BLOCKS:
            units = []
            for _ in range(3):
                def small():
                    return (torch.randn((C,), generator=g, device=dev)
                            * 0.2).to(dtype)
                units.append({"alpha1": small(), "beta1": small(),
                              "conv1": init_conv1d(g, C, C, 7, dev,
                                                   dtype=dtype),
                              "alpha2": small(), "beta2": small(),
                              "conv2": init_conv1d(g, C, C, 1, dev,
                                                   dtype=dtype)})
            x = (torch.randn((B, C, T), generator=g, device=dev)
                 * 0.5).to(dtype)
            caches = [(torch.randn((B, C, 6 * d), generator=g, device=dev)
                       * 0.5).to(dtype) for d in (1, 3, 9)]
            t1 = T // 2
            checks = []
            out = resunit.fused_resunit_stack(x, units, None)[0]
            ref = resunit.fused_resunit_stack_plain(x, units, None)[0]
            checks.append(("whole", out, ref))
            o1, c1 = resunit.fused_resunit_stack(x[..., :t1], units, caches)
            o2, c2 = resunit.fused_resunit_stack(x[..., t1:], units, c1)
            r1, d1 = resunit.fused_resunit_stack_plain(x[..., :t1], units,
                                                       caches)
            r2, d2 = resunit.fused_resunit_stack_plain(x[..., t1:], units,
                                                       d1)
            checks += [("chunk1", o1, r1), ("chunk2", o2, r2)]
            checks += [(f"cache{u}", a, b)
                       for u, (a, b) in enumerate(zip(c2, d2))]
            torch.cuda.synchronize()
            errs = []
            for what, a, b in checks:
                if a.dtype != dtype or b.dtype != dtype:
                    raise AssertionError(f"{name} B={B} C={C} T={T} {what}: "
                                         f"{a.dtype} / {b.dtype}")
                a, b = a.float(), b.float()
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{name} B={B} C={C} T={T} {what}: "
                                         "not finite")
                e = (a - b).abs().max().item()
                rel = e / max(b.abs().max().item(), 1e-30)
                if rel > tol:
                    raise AssertionError(f"{name} B={B} C={C} T={T} {what}: "
                                         f"rel err {rel} > {tol}")
                errs.append((e, rel))
            ms, plain_ms = alternate_times(
                lambda: resunit.fused_resunit_stack_plain(x, units, None),
                lambda: resunit.fused_resunit_stack(x, units, None),
                iters=10)
            # per unit: 7*C + C multiply-adds per output sample-channel
            flops = 3 * 2 * 8 * C * C * B * T
            e_abs = max(e for e, _ in errs)
            e_rel = max(r for _, r in errs)
            worst_abs, worst_rel = max(worst_abs, e_abs), max(worst_rel,
                                                              e_rel)
            ms_sum, plain_sum, flops_sum = (ms_sum + ms, plain_sum + plain_ms,
                                            flops_sum + flops)
            bm, bn = resunit.plan_tiles(B, C, T, sms)
            log(f"{name} fused_resunit_stack B={B} C={C} T={T} tile {bm}x{bn}"
                f" (whole + 2 streamed chunks, caches) max_abs_err="
                f"{e_abs:.3e} max_rel_err={e_rel:.3e} (tol {tol} rel)"
                f" kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} TFLOP/s="
                f"{flops / (ms * 1e-3) / 1e12:.2f} plain_TFLOP/s="
                f"{flops / (plain_ms * 1e-3) / 1e12:.2f}")
        # x in and out (and no caches: the timed call is whole), the three
        # units' weights once (conv weights in the kernel's type, biases and
        # snake constants float32); float32 runs each multiply-add as three
        # TF32 tensor-core products (3xTF32) at the TF32 peak, bf16 as one
        # bf16 product at the bf16 peak
        elem = 2 if bf16 else 4
        nbytes = sum(elem * 2 * B * C * T + 3 * (elem * 8 * C * C + 4 * 6 * C)
                     for C, T in K2_BLOCKS)
        bnd = (bound(nbytes, flops_sum, "bf16") if bf16
               else bound(nbytes, 3 * flops_sum, "tf32"))
        r = result(worst_abs, ms_sum, plain_sum, bnd)
        r["max_rel_err"] = worst_rel
        log(f"{name} all four blocks B={B}: kernel_ms={ms_sum:.4f} plain_ms="
            f"{plain_sum:.4f} TFLOP/s={flops_sum / (ms_sum * 1e-3) / 1e12:.2f}"
            f" plain_TFLOP/s={flops_sum / (plain_sum * 1e-3) / 1e12:.2f} "
            f"max_rel_err={worst_rel:.3e} (tol {tol}) {bound_text(r)}")
        res[B] = r
    worst = max(r["max_abs_err"] for r in res.values())
    return {**res[4], "max_abs_err": worst,
            "max_rel_err": max(r["max_rel_err"] for r in res.values())}


# ---------------------------------------------------------------------------
# phase 4b: CSM's codec and watermark
# ---------------------------------------------------------------------------

# relative to max |reference|: the float32 Mimi decoder on the card (TF32
# off) against the CPU, the same math summed in another order; streamed
# chunks against the whole decode on the card (position-exact masks: only
# the summation order differs); the bf16 codec against float32 (2^-5,
# about 3x the 1.1e-2 the CPU measures at these shapes)
MIMI_REL_TOL = 1e-4
MIMI_CHUNK_REL_TOL = 1e-5
MIMI_BF16_REL_TOL = 2.0 ** -5
# the spectral watermark, card vs CPU, absolute on audio in [-1, 1] (float32
# FFTs in another order); SilentCipher's encode, relative to max |ref|
WATERMARK_TOL = 1e-5
SC_REL_TOL = 1e-4


def check_codec() -> dict:
    """CSM's detokenize path at full width: the Mimi decoder (random
    weights from a seed) for 4 streams x 10 frames, whole and as two
    streamed chunks (4 + 6 frames) with caches, on the card against the CPU
    in float32, then cast to bf16 (the codec at ``--codec-dtype bfloat16``)
    against float32; the spectral watermark over one 19,200-sample chunk
    per stream, its resample to 44.1 kHz and SilentCipher's encode (random
    params, a 512-row message band) over a chunk of noise at that rate,
    card vs CPU. Prints CUDA-event times (graph
    replays) of each."""
    import torch

    from vox_serve_tpu_torch.codecs import mimi
    from vox_serve_tpu_torch.params import tree_map
    from vox_serve_tpu_torch.watermark import (SILENTCIPHER_KEY,
                                               WatermarkConfig,
                                               apply_watermark,
                                               init_watermarker)
    from vox_serve_tpu_torch.watermark import silentcipher as sc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = mimi.MimiConfig()
    g = torch.Generator().manual_seed(6)
    params = mimi.init_mimi(cfg, g, "cpu")
    B, T, cut = 4, 10, 4
    codes = torch.randint(0, 2048, (B, 32, T), generator=g)

    def to(tree, device, dtype=None):
        return tree_map(lambda a: a.to(device, dtype) if dtype is not None
                        and a.dtype == torch.float32 else a.to(device), tree)

    def decode(p, device, dtype=None):
        c = codes.to(device)
        whole = mimi.mimi_decode_chunk(p, cfg, c, None)[0]
        cache0 = to(mimi.mimi_init_cache(cfg, B, device), device, dtype)
        a, cache = mimi.mimi_decode_chunk(p, cfg, c[..., :cut], cache0)
        cache = tree_map(lambda x, r: x.to(r.dtype), cache, cache0)
        b, _ = mimi.mimi_decode_chunk(p, cfg, c[..., cut:], cache)
        return whole.float().cpu(), torch.cat([a, b], -1).float().cpu()

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    ref_whole, ref_chunks = decode(params, "cpu")
    pc = to(params, dev)
    whole, chunks = decode(pc, dev)
    pb = to(params, dev, torch.bfloat16)
    b_whole, b_chunks = decode(pb, dev, torch.bfloat16)
    errs = {"card_vs_cpu": max(rel(whole, ref_whole), rel(chunks, ref_chunks)),
            "chunks_vs_whole": rel(chunks, whole),
            "bf16_vs_f32": max(rel(b_whole, ref_whole),
                               rel(b_chunks, ref_whole)),
            "bf16_chunks_vs_whole": rel(b_chunks, b_whole)}
    tols = {"card_vs_cpu": MIMI_REL_TOL, "chunks_vs_whole": MIMI_CHUNK_REL_TOL,
            "bf16_vs_f32": MIMI_BF16_REL_TOL,
            "bf16_chunks_vs_whole": MIMI_BF16_REL_TOL}
    shape = (B, 1, T * cfg.frame_samples)
    for out in (whole, chunks, b_whole, b_chunks):
        if tuple(out.shape) != shape or not torch.isfinite(out).all():
            raise AssertionError(f"Mimi decode: shape {tuple(out.shape)} or "
                                 "not finite")
    for k, e in errs.items():
        if e > tols[k]:
            raise AssertionError(f"Mimi {k}: rel err {e} > {tols[k]}")
    c = codes.to(dev)
    ms = {dt: cuda_time_ms(lambda p=p: mimi.mimi_decode_chunk(p, cfg, c, None),
                           iters=5, graph=True)
          for dt, p in (("f32", pc), ("bf16", pb))}
    log(f"Mimi decoder (full width: 8 x 512 transformer, window 250, SEANet "
        f"rates {cfg.upsample_ratios}) B={B} x {T} frames, whole and "
        f"{cut} + {T - cut} streamed: "
        + " ".join(f"{k}={v:.3e} (tol {tols[k]})" for k, v in errs.items())
        + f"; graph ms per decode f32={ms['f32']:.3f} bf16={ms['bf16']:.3f} "
        f"({T / 12.5 * 1e3:.0f} ms of audio per stream)")

    wcfg = WatermarkConfig()
    wp = init_watermarker(wcfg, torch.Generator().manual_seed(101), "cpu")
    audio = ref_whole[:, 0]
    ref = apply_watermark(wp, wcfg, audio)
    wpc, ac = to(wp, dev), audio.to(dev)
    got = apply_watermark(wpc, wcfg, ac).cpu()
    wm_err = (got - ref).abs().max().item()
    if not torch.isfinite(got).all() or wm_err > WATERMARK_TOL:
        raise AssertionError(f"spectral watermark card vs CPU: {wm_err}")
    wm_ms = cuda_time_ms(lambda: apply_watermark(wpc, wcfg, ac), graph=True)
    log(f"spectral watermark B={B} x {audio.shape[1]} samples: card vs CPU "
        f"max_abs_err={wm_err:.3e} (tol {WATERMARK_TOL}); graph ms "
        f"{wm_ms:.3f}; mark size {(ref - audio).abs().max().item():.3e}")

    # the message band cut to 512 rows, as in the JAX package's parity
    # test: the default 1024 exceeds the 513 bins of a 1024-point STFT
    scfg = sc.SilentCipherConfig(message_band_size=512)
    scp = sc.init_silentcipher(scfg, g, "cpu")
    onehot = torch.from_numpy(sc.message_to_symbols(list(SILENTCIPHER_KEY),
                                                    scfg))
    y = sc.sinc_resample(audio[:1], wcfg.sample_rate, scfg.sr)
    up_err = (sc.sinc_resample(ac[:1], wcfg.sample_rate, scfg.sr).cpu()
              - y).abs().max().item()
    if up_err > WATERMARK_TOL:
        raise AssertionError(f"sinc_resample card vs CPU: {up_err}")
    # the encode over white noise of the resampled chunk's length: a bin
    # with next to no energy (above the resampled audio's 12 kHz band)
    # takes its phase from rounding, and the mark's energy lands there
    # with that phase, so only a signal with energy in every bin compares
    # sample for sample
    y = torch.randn(y.shape, generator=g) * 0.1
    ref = sc.sc_encode(scp, scfg, y, onehot)
    scc, yc, oc = to(scp, dev), y.to(dev), onehot.to(dev)
    got = sc.sc_encode(scc, scfg, yc, oc).cpu()
    sc_err = rel(got, ref)
    if not torch.isfinite(got).all() or sc_err > SC_REL_TOL:
        raise AssertionError(f"sc_encode card vs CPU: rel err {sc_err}")
    sc_ms = cuda_time_ms(lambda: sc.sc_encode(scc, scfg, yc, oc), iters=5,
                         graph=True)
    log(f"SilentCipher: sinc_resample 24 -> 44.1 kHz card vs CPU "
        f"max_abs_err={up_err:.3e} (tol {WATERMARK_TOL}); sc_encode (random "
        f"params) 1 x {y.shape[1]} samples of noise at 44.1 kHz: card vs CPU "
        f"max_rel_err={sc_err:.3e} (tol {SC_REL_TOL}); graph ms {sc_ms:.3f}")
    return {**errs, "watermark": wm_err, "sc_encode": sc_err}


# ---------------------------------------------------------------------------
# phase 5: end to end over HTTP
# ---------------------------------------------------------------------------

PROMPTS = [
    "Streaming speech from the port.",
    "Four requests share one batch..",
    "Every frame runs both kernels!!",
    "The codec turns codes to audio.",
]
SAMPLE_RATE = 24000
#: the published ids whose synthetic snapshots the checkpoint phase writes
QWEN3_BASE = "Qwen/Qwen3-TTS-12Hz-1.7B-Base"
QWEN3_DESIGN = "Qwen/Qwen3-TTS-12Hz-1.7B-VoiceDesign"
QWEN3_CODEC = "Qwen/Qwen3-TTS-Tokenizer-12Hz"
CSM_ID = "sesame/csm-1b"
ORPHEUS_ID = "canopylabs/orpheus-3b-0.1-ft"
SNAC_ID = "hubertsiuzdak/snac_24khz"
SC_ID = "sony/silentcipher"
COSY_ID = "FunAudioLLM/CosyVoice2-0.5B"
GLM_ID = "zai-org/glm-4-voice-9b"
GLM_DECODER = "zai-org/glm-4-voice-decoder"
GLM_TOKENIZER = "zai-org/glm-4-voice-tokenizer"
STEP_ID = "stepfun-ai/Step-Audio-2-mini"
CHATTERBOX_ID = "ResembleAI/chatterbox"
PERTH_ID = "resemble-ai/perth"
ZONOS_ID = "Zyphra/Zonos-v0.1-transformer"
DAC_ID = "descript/dac_44khz"
ZONOS_SPEAKER_ID = "Zyphra/Zonos-v0.1-speaker-embedding"
#: the ``--model`` each run serves (``qwen3-tts`` unless listed here); L, M,
#: N and P by published id, from the checkpoint phase's hub cache
MODEL_OF = {"I": "orpheus", "Y": "orpheus", "J": "csm", "K": "csm",
            "L": QWEN3_BASE,
            "M": QWEN3_DESIGN, "N": CSM_ID, "O": "cosyvoice2", "P": COSY_ID,
            "Q": "glm", "R": GLM_ID, "S": "step-audio-2", "T": STEP_ID,
            "U": "chatterbox", "V": CHATTERBOX_ID, "W": "zonos",
            "X": ZONOS_ID, "TPG": "glm"}
#: the family of a served id (its layers, audio unit and form fields)
FAMILY = {"orpheus": "orpheus", "csm": "csm", CSM_ID: "csm",
          "cosyvoice2": "cosyvoice2", COSY_ID: "cosyvoice2", "glm": "glm",
          GLM_ID: "glm", "step-audio-2": "step", STEP_ID: "step",
          "chatterbox": "chatterbox", CHATTERBOX_ID: "chatterbox",
          "zonos": "zonos", ZONOS_ID: "zonos"}


def family(config: str) -> str:
    return FAMILY.get(MODEL_OF.get(config, "qwen3-tts"), "qwen3-tts")


#: ``--max-tokens`` where a run's prompts are longer than the family's
#: default budget: L's ICL prompts carry 38 reference frames and the
#: reference transcript, M's the instruct text, N's the default
#: two-speaker context (its two transcripts, 946 characters through the
#: char-level dev tokenizer, and two 0.96 s prompt WAVs), P's clones the
#: reference's 75 S3 v2 tokens and its transcript (prompts of up to 151
#: tokens; 280 leaves each stream at least 128 audio tokens, 5 windows)
MAX_TOKENS = {"L": 200, "M": 140, "N": 1072, "P": 280}


def max_tokens(config: str) -> int:
    return MAX_TOKENS.get(config, MODELS[family(config)]["max_tokens"])
#: per model: ``--max-tokens`` (absolute positions), and the audio unit a
#: run counts with its samples: a Qwen3 codec frame (42-token prompts ->
#: ~60 frames), one Orpheus window (7 tokens; 42-token prompts -> ~119
#: tokens, 14 overlapped windows) or one CosyVoice2 window (25 tokens, 1 s;
#: 33-token prompts -> ~127 tokens, 5 overlapped windows)
MODELS = {
    "qwen3-tts": {"max_tokens": 100, "unit": "frames", "unit_samples": 1920},
    "orpheus": {"max_tokens": 160, "unit": "windows", "unit_samples": 2048},
    "csm": {"max_tokens": 100, "unit": "frames", "unit_samples": 1920},
    "cosyvoice2": {"max_tokens": 160, "unit": "windows",
                   "unit_samples": 24000},
    # GLM-4-Voice: one 25-token window = 172 mel frames = 44,032 samples.
    # Under random weights about a tenth of the sampled ids are audio ids,
    # so a window takes ~240 decode steps: 1,600 positions leave the
    # speech-upload streams (prompts of ~870 tokens) ~730 steps, ~75 audio
    # tokens (at least 50, two full windows, but for a 0.3% tail), and the
    # text streams (~315) ~1,290 steps
    "glm": {"max_tokens": 1600, "unit": "windows", "unit_samples": 44032},
    # Step-Audio-2-mini: one 28-token window every 25 tokens = 50 mel
    # frames = 24,000 samples. Under random weights 7,024 of the 158,720
    # ids (4.4%) are audio ids that are not stop ids, so the first window
    # takes ~630 decode steps and each later one ~565: the family's 2,048
    # positions leave a ~140-token prompt ~1,900 steps, ~84 audio tokens
    # (sd ~9), three windows (fewer than two in ~0.03% of streams)
    "step": {"max_tokens": 2048, "unit": "windows", "unit_samples": 24000},
    # Chatterbox: one 25-token window every 22 tokens = 44 mel frames =
    # 21,120 samples. The dev tokenizer spells each space as "[SPACE]", so
    # the prompts are 34 conditioning rows + ~55-60 text rows + the start
    # row (~92-97); 220 positions leave each stream ~124 audio tokens (a
    # stop is 1 id of 6,563), five windows (four need 91)
    "chatterbox": {"max_tokens": 220, "unit": "windows",
                   "unit_samples": 21120},
    # Zonos: one 50-token window every 41 tokens = 41 DAC frames = 11,425
    # samples at 24 kHz. Each prompt is its text's phonemes (the text
    # passes through: no espeak) + 8 conditioning rows, 39 here; 220
    # positions leave ~181 tokens, four full windows (they need 173) and
    # a partial one (a stop is 1 id of 1,025 on codebook 0)
    "zonos": {"max_tokens": 220, "unit": "windows", "unit_samples": 11425},
}
#: per model: backbone layers (each decode step launches the decode kernel
#: once per layer, each prefill K3 once per layer)
LAYERS = {"qwen3-tts": 28, "orpheus": 28, "csm": 16, "cosyvoice2": 24,
          "glm": 40, "step": 28, "chatterbox": 30, "zonos": 26}
#: per model: the /generate form fields besides the text (CSM's speaker is
#: an integer id)
FORM = {"csm": {"speaker": "0"}}
#: Qwen3's and CSM's detokenize interval (frames) and samples per frame
FRAME_WINDOWS = (10, 1920)
#: the overlap codecs: detokenize window, overlap and samples emitted per
#: window (Orpheus keeps 2048 of SNAC's 8192; CosyVoice2 emits 25 tokens =
#: 50 mel frames = 1 s), and the windows each served stream must reach
OVERLAP_WINDOWS = {"orpheus": (28, 21, 2048), "cosyvoice2": (28, 3, 24000),
                   "step": (28, 3, 24000), "chatterbox": (25, 3, 21120),
                   "zonos": (50, 9, 11425)}
MIN_WINDOWS = {"orpheus": 6, "cosyvoice2": 4, "step": 2, "chatterbox": 4,
               "zonos": 4}
#: where a run's every stream may sample its stop id early, the windows
#: its longest stream must decode instead of ``MIN_WINDOWS``: Zonos's EOS
#: is 1 of 1,025 ids on codebook 0, and under random heads more than half
#: of its streams stop before their cap
RUN_MIN_WINDOWS = {"zonos": 2}


def overlap_pcm_samples(n_tokens: int, interval: int = 28, overlap: int = 21,
                        window: int = 2048) -> int:
    """The PCM a stream of ``n_tokens`` audio tokens must emit under the
    overlap trim rule of an overlap codec (``OVERLAP_WINDOWS``: Orpheus's
    by default): windows every ``interval - overlap`` tokens until one
    reaches the last token, ``window`` samples each, a last window of fewer
    than ``interval - overlap`` tokens trimmed (the worker's
    ``_resolve_detok`` and the scheduler's window selection)."""
    step, s, total = interval - overlap, 0, 0
    while True:
        last = min(interval, n_tokens - s)
        total += window if last >= step else max(
            int(window * (last - 0.5) / step), 0)
        if s + interval >= n_tokens:
            return total
        s += step

#: GLM-4-Voice's windows: 25 tokens, no overlap; a window of L tokens
#: decodes feat_len(L) mel frames of 256 samples (44,032 per 25 tokens; a
#: 100-token catch-up window 689 frames, not 4 x 172)
GLM_INTERVAL = 25
MIN_GLM_WINDOWS = 2


def glm_window_samples(n_tokens: int) -> int:
    """The samples a GLM detokenize window of ``n_tokens`` tokens decodes:
    int(L / 12.5 Hz x 22,050 / 256) mel frames of 256 samples."""
    return int(n_tokens / 12.5 * 22050 / 256) * 256


def window_pcm_samples(n_tokens: int, windows, samples_of=glm_window_samples
                       ) -> int:
    """The PCM a stream of a codec without overlap (GLM-4-Voice) must emit
    for ``n_tokens`` audio tokens over the detokenize ``windows`` its
    daemon reports ((first token, length) pairs, the interval or a
    catch-up window): the windows must tile the tokens from 0 with no gap
    or repeat; each emits ``samples_of(length)`` samples, a last window
    holding fewer tokens than its length int(samples x (tokens - 0.5) /
    length) (the worker's trim)."""
    total = pos = 0
    for start, L in sorted(tuple(w) for w in windows):
        if start != pos or start >= n_tokens:
            raise AssertionError(f"windows {windows} do not tile "
                                 f"{n_tokens} tokens (at token {pos})")
        last = min(L, n_tokens - start)
        S = samples_of(L)
        total += S if last >= L else max(int(S * (last - 0.5) / L), 0)
        pos = start + L
    if pos < n_tokens:
        raise AssertionError(f"windows {windows} do not cover {n_tokens} "
                             "tokens")
    return total


K1, K1Q, K4 = ("paged_decode_attention", "paged_decode_attention_quant",
               "paged_decode_attention_pair")
K3, K2 = "ragged_prefill_attention", "fused_resunit_stack"
K2H = "fused_resunit_stack_bf16"
K5 = "w8a16_linear"
#: K5's launches per layer of a prefill or decode step: q/k/v grouped, o,
#: gate/up grouped, down
K5_PER_LAYER = 4
#: K6, the depth loop's layer kernels: every run of a family with a depth
#: transformer launches all four
K6 = ("depth_add_rms_norm", "depth_qkv_rope", "depth_attention",
      "depth_silu_mul")


def depth_kernels(config: str) -> frozenset:
    """K6 for a run of Qwen3-TTS or CSM (their depth loops), else none."""
    return frozenset(K6 if family(config) in ("qwen3-tts", "csm") else ())


#: served configurations: name -> (launch flags, environment, what the
#: daemon must report it served, kernels that must launch). Every other
#: kernel must not launch in that run.
SINGLE = {"fused_decode_steps": 0, "pipeline_depth": 0,
          "first_chunk_frames": 0}
#: what A-F serve besides: the online scheduler, the codec in float32 and
#: the whole generation budget reserved at admission, no watermark
ONLINE_F32 = {"scheduler_type": "online", "codec_dtypes": ["float32"],
              "kv_reserve_fraction": 1.0, "watermark": None}
BF16_CODEC = ["--codec-dtype", "bfloat16"]
FUSED = ["--fused-decode-steps", "4", "--fused-decode-buckets", "1,4",
         "--pipeline-depth", "2"]
CONFIGS = {
    "A": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32},
          {K1, K3}),
    "B": (["--kv-quant", "int8"], {"VOX_FUSED_RESUNIT": "1"},
          {"kv_layout": "combined", "kv_pool_dtype": "int8",
           "fused_resunit": True, **SINGLE, **ONLINE_F32}, {K1Q, K3, K2}),
    "C": (["--kv-quant", "f8_e4m3"], {},
          {"kv_layout": "combined", "kv_pool_dtype": "float8_e4m3fn",
           "fused_resunit": False, **SINGLE, **ONLINE_F32}, {K1Q, K3}),
    "D": ([], {"VOX_KV_COMBINED": "0"},
          {"kv_layout": "pair", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, **SINGLE, **ONLINE_F32}, {K4, K3}),
    "E": (FUSED, {},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, "fused_decode_steps": 4,
           "pipeline_depth": 2, "first_chunk_frames": 0, **ONLINE_F32},
          {K1, K3}),
    "F": (["--first-chunk-frames", "3", *FUSED, "--detok-pipeline-depth",
           "2"], {},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, "fused_decode_steps": 4,
           "pipeline_depth": 2, "first_chunk_frames": 3,
           "detok_pipeline_depth": 2, **ONLINE_F32}, {K1, K3}),
    "G": ([*BF16_CODEC, "--scheduler-type", "input_streaming",
           "--kv-reserve-fraction", "0.05"], {"VOX_FUSED_RESUNIT": "1"},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": True, **SINGLE,
           "scheduler_type": "input_streaming", "codec_dtypes": ["bfloat16"],
           "kv_reserve_fraction": 0.05}, {K1, K3, K2H}),
    "H": ([*BF16_CODEC, "--scheduler-type", "offline"], {},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, **SINGLE, "scheduler_type": "offline",
           "codec_dtypes": ["bfloat16"], "kv_reserve_fraction": 1.0},
          {K1, K3}),
    # Orpheus-3B (MODEL_OF): G = 3 in K1 and K3, the float32 SNAC codec in
    # overlapped windows, no first-chunk ramp (an overlap codec turns it off)
    "I": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32},
          {K1, K3}),
    # I at --weight-quant int8: the backbone's matmuls through K5 over int8
    # weights in every prefill and decode graph
    "Y": (["--weight-quant", "int8"], {},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, **SINGLE, **ONLINE_F32,
           "weight_quant": "int8"}, {K1, K3, K5}),
    # CSM-1B (MODEL_OF): G = 4 at D=64 in K1 and K3, 16 layers, the
    # 31-codebook depth step in every decode graph, the Mimi codec with its
    # transformer ring in the slot cache, the spectral watermark in every
    # detokenize graph. K: the paths of the JAX csm profile at this batch
    # (bf16 codec, first-chunk ramp, fused decode, pipelines); CSM's rows do
    # not chain (the JAX model's flag), so no cold chain
    "J": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "watermark": "spectral"}, {K1, K3}),
    "K": ([*BF16_CODEC, "--first-chunk-frames", "3", *FUSED,
           "--detok-pipeline-depth", "2"], {},
          {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
           "fused_resunit": False, "fused_decode_steps": 4,
           "pipeline_depth": 2, "first_chunk_frames": 3,
           "detok_pipeline_depth": 2, "scheduler_type": "online",
           "codec_dtypes": ["bfloat16"], "kv_reserve_fraction": 1.0,
           "watermark": "spectral"}, {K1, K3}),
}
#: what L, M and N load from their snapshots: a part False (random init
#: after a failed mapping) or missing fails the run
QWEN3_LOADED = {"talker": True, "codec": True, "codec_encoder": True}
CONFIGS.update({
    # Qwen3-TTS Base from a full-width synthetic checkpoint: two ICL voice
    # clones (an uploaded reference WAV and its transcript: the ECAPA
    # x-vector and the Mimi encoder's reference frames in the prompt), one
    # x-vector-only clone, one request without audio
    "L": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False,
                   "checkpoint": {**QWEN3_LOADED, "speaker_encoder": True}},
          {K1, K3}),
    # VoiceDesign: the same talker without a speaker encoder, two instruct
    # streams, no speaker row
    "M": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False,
                   "checkpoint": {**QWEN3_LOADED, "speaker_encoder": None}},
          {K1, K3}),
    # J's configuration from the sesame/csm-1b snapshot: the backbone, the
    # Mimi codec and its encoder, the default two-speaker context in every
    # prompt
    "N": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "watermark": "spectral", "tokenizer_loaded": False,
                   "checkpoint": {"backbone": True, "codec": True,
                                  "codec_encoder": True}}, {K1, K3}),
})
#: what P loads from its snapshot: every part, or the run fails
COSY_LOADED = {"backbone": True, "flow": True, "hift": True, "s3v2": True,
               "campplus": True}
CONFIGS.update({
    # CosyVoice2-0.5B (MODEL_OF): the Qwen2 talker with q/k/v biases, G = 7
    # at D=64 in K1 and K3; detokenize graphs that hold the flow (10 CFG
    # Euler steps on a doubled batch) and streaming HiFT over overlapped
    # 28-token windows and their catch-up windows, the flow cache in the
    # slot; A's flags
    "O": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32},
          {K1, K3}),
    # O's configuration from the FunAudioLLM/CosyVoice2-0.5B snapshot: two
    # voice clones (an uploaded WAV + ref_text), a clone without ref_text,
    # a request without audio; S3 v2 and CAMPPlus on the card
    "P": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False, "checkpoint": COSY_LOADED},
          {K1, K3}),
})
#: what Q and R load: Q nothing (random weights from the seed); R the
#: decoder and the speech tokenizer from their snapshots, the backbone from
#: random init (its repo is not in the cache), as the JAX package serves it
GLM_RANDOM = {"backbone": False, "flow": False, "hift": False,
              "vq_encoder": False}
CONFIGS.update({
    # GLM-4-Voice-9B (MODEL_OF): the 40 x 4096 GLM-4 backbone with the
    # interleaved partial rope, K1/K3 at G = 16 and D=128; the GLM flow and
    # 22.05 kHz HiFT inside the detokenize graphs over 25-token windows with
    # no overlap, the HiFT cache in the slot; two speech uploads (the
    # Whisper-VQ encoder on the card in preprocess) and two text streams;
    # A's flags
    "Q": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False, "checkpoint": GLM_RANDOM},
          {K1, K3}),
    # Q's configuration with the decoder and tokenizer snapshots in the hub
    # cache: flow, HiFT and the Whisper-VQ encoder from them
    "R": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False,
                   "checkpoint": {**GLM_RANDOM, "flow": True, "hift": True,
                                  "vq_encoder": True}}, {K1, K3}),
})
#: what S and T load: S nothing (random weights from the seed); T the flow
#: and HiFT from the snapshot's token2wav files, while its LM (4 of 28
#: layers) does not map, so the backbone and the audio encoder (which
#: loads only with the LM) are random, as the JAX package serves them
STEP_RANDOM = {"backbone": False, "encoder": False, "flow": False,
               "hift": False}
CONFIGS.update({
    # Step-Audio-2-mini (MODEL_OF): the 28 x 3584 Qwen2.5-7B backbone with
    # q/k/v biases, K1/K3 at G = 7 and D=128; the audio encoder and adaptor
    # on the card in preprocess, their rows spliced over the prompt's
    # <audio> markers; the DiT flow and streaming HiFT inside the detokenize
    # graphs over overlapped 28-token windows; two speech uploads and two
    # text streams; A's flags
    "S": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False, "checkpoint": STEP_RANDOM},
          {K1, K3}),
    # S's configuration from the stepfun-ai/Step-Audio-2-mini snapshot in
    # the hub cache: one upload, one text stream
    "T": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False,
                   "checkpoint": {**STEP_RANDOM, "flow": True,
                                  "hift": True}}, {K1, K3}),
})
#: what U and V load: U nothing (random weights from the seed, the dev
#: spectral watermark); V every part of the ResembleAI/chatterbox snapshot
#: (the T3 LM and its conditioning encoder, the flow, HiFT, S3 v2 and
#: CAMPPlus from s3gen.safetensors, the default voice from conds.pt) and
#: Perth from the resemble-ai/perth snapshot
CHATTERBOX_PARTS = ("backbone", "cond_enc", "flow", "hift", "s3v2",
                    "campplus", "conds")
CONFIGS.update({
    # Chatterbox (MODEL_OF): the 30 x 1024 T3 backbone, K1/K3 at G = 1 and
    # D=64, its learned speech positions by gen_idx in every decode graph;
    # the CosyVoice flow and 24 kHz HiFT inside the detokenize graphs over
    # overlapped 25-token windows, with the watermark; 4 text streams; A's
    # flags
    "U": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "watermark": "spectral", "tokenizer_loaded": False,
                   "checkpoint": dict.fromkeys(CHATTERBOX_PARTS, False)},
          {K1, K3}),
    # U's configuration from the ResembleAI/chatterbox and
    # resemble-ai/perth snapshots: 2 default-voice streams (conds.pt), 2
    # uploads (S3 v2 and CAMPPlus on the card in preprocess); Perth in every
    # detokenize graph
    "V": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "watermark": "perth", "tokenizer_loaded": False,
                   "checkpoint": dict.fromkeys(CHATTERBOX_PARTS, True)},
          {K1, K3}),
})
#: what W and X load: W nothing (random weights from the seed); X the LM
#: (with its prefix conditioner), DAC and the speaker net from their three
#: snapshots
ZONOS_PARTS = ("backbone", "codec", "speaker_encoder")
CONFIGS.update({
    # Zonos-v0.1 (MODEL_OF): the 26 x 2048 LayerNorm backbone, K1/K3 at G =
    # 1 and D=128, 9 codebooks sampled together with the delay pattern by
    # gen_idx in every graph; DAC and the 24 kHz resample inside the
    # detokenize graphs over overlapped 50-token windows; 4 text streams;
    # A's flags
    "W": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False,
                   "checkpoint": dict.fromkeys(ZONOS_PARTS, False)},
          {K1, K3}),
    # W's configuration from the three Zonos snapshots: 2 uploads (the
    # speaker net on the card in preprocess), 2 text streams
    "X": ([], {}, {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
                   "fused_resunit": False, **SINGLE, **ONLINE_F32,
                   "tokenizer_loaded": False,
                   "checkpoint": dict.fromkeys(ZONOS_PARTS, True)},
          {K1, K3}),
})
CONFIGS.update({
    # tensor parallelism over four cards (``four_card_phase``): A at
    # --tp-size 4, the flagship's backbone and KV pool split 4 ways (4 / 2
    # heads a rank); Q at --tp-size 4 --weight-quant int8, GLM-4-Voice-9B's
    # (8 / 1 heads a rank, K5 at the shard widths)
    "TP": (["--tp-size", "4"], {}, {**CONFIGS["A"][2], "tp_size": 4},
           {K1, K3}),
    "TPG": (["--tp-size", "4", "--weight-quant", "int8"], {},
            {**CONFIGS["Q"][2], "tp_size": 4, "weight_quant": "int8"},
            {K1, K3, K5}),
})
#: the tensor-parallel runs and the one-card runs each is compared with
TP_RUNS = {"TP": "A", "TPG": "Q"}
TP_SIZE = 4
#: the runs served from random weights, and those from checkpoints (the
#: checkpoint phase writes their snapshots)
RANDOM_RUNS = "ABCDEFGHIYJKOQSUW"

#: every serving-profile flag at the value the runs above served before the
#: launcher applied the profiles (the generic defaults): a run's own flags
#: come first and these fill the rest, so each run serves what it names
#: whatever its family's profile holds (the profiles' batch-scaled lattices
#: are dropped by the launcher under the runs' --max-batch-size 4)
PINNED = {"--page-size": "16", "--pipeline-depth": "0",
          "--first-chunk-frames": "0", "--ramp-frames": "0",
          "--fused-decode-steps": "0", "--detok-pipeline-depth": "1",
          "--codec-dtype": "float32", "--prefill-buckets": "128,1024",
          "--max-prefill-requests": "8", "--kv-reserve-fraction": "1.0"}


def pinned(flags: list) -> list:
    """``flags`` followed by every ``PINNED`` flag they do not set."""
    return [*flags, *(x for k, v in PINNED.items() if k not in flags
                      for x in (k, v))]


#: the flagship as its users start it: ``--model qwen3-tts`` with no batch,
#: page, lattice, pipeline or codec flag (its H100 profile applies); one
#: wave of as many streams as the profile's top decode bucket
PROFILE_RUN = "Z"


def profile_config() -> tuple:
    """Run Z's entry of ``CONFIGS``: what the daemon must serve is the
    profile of ``vox_serve_tpu_torch/profiles.py``."""
    from vox_serve_tpu_torch.profiles import resolve_profile

    prof = resolve_profile("qwen3-tts")

    def buckets(spec):
        return [int(x) for x in spec.split(",")]

    served = {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
              "fused_resunit": False, "scheduler_type": "online",
              "watermark": None,
              "max_batch_size": prof["max_batch_size"],
              "num_pages": prof["max_num_pages"],
              "page_size": prof["page_size"],
              "decode_buckets": buckets(prof["decode_buckets"]),
              "prefill_token_buckets": buckets(prof["prefill_buckets"]),
              "pipeline_depth": prof["pipeline_depth"],
              "fused_decode_steps": prof["fused_decode_steps"],
              "first_chunk_frames": prof["first_chunk_frames"],
              "detok_pipeline_depth": prof["detok_pipeline_depth"],
              "kv_reserve_fraction": prof["kv_reserve_fraction"] or 1.0,
              "codec_dtypes": [prof["codec_dtype"] or "float32"]}
    return [], {}, served, {K1, K3}


#: the two-card runs (``torch.cuda.device_count() >= 2``): DG, Qwen3 with
#: the LM on cuda:0 and the detokenizer (the codec with K2, every
#: detokenize graph) on cuda:1, driven by the disaggregation scheduler's
#: two threads (``--scheduler-type disaggregation`` sets
#: ``--enable-disaggregation``); DP, A's flags at --dp-size 2, one daemon a
#: card, both of which must serve streams
CONFIGS.update({
    "DG": (["--scheduler-type", "disaggregation"], {"VOX_FUSED_RESUNIT": "1"},
           {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
            "fused_resunit": True, **SINGLE, **ONLINE_F32,
            "scheduler_type": "disaggregation",
            "lm_device": "cuda:0", "detokenizer_device": "cuda:1"},
           {K1, K3, K2}),
    "DP": (["--dp-size", "2"], {},
           {"kv_layout": "combined", "kv_pool_dtype": "bfloat16",
            "fused_resunit": False, **SINGLE, **ONLINE_F32, "rank": 0},
           {K1, K3}),
})
#: the waves of concurrent requests a run serves, in turn (F's solo stream
#: first: alone, the online scheduler takes the cold-start chain)
WAVES = {"F": (1, 4), "M": (2,), "T": (2,)}
#: per run, each request's form fields besides the text and whether it
#: uploads the reference WAV (``audio``); other runs send FORM's fields
REF_TEXTS = ("A short reference clip for the voice clone.",
             "Another transcript of the same reference.")
INSTRUCTS = ("A warm, low voice, speaking slowly.",
             "Bright and fast, like a sports announcer.")
REQUESTS = {
    "L": [{"fields": {"language": "english", "ref_text": REF_TEXTS[0]},
           "audio": True},
          {"fields": {"language": "english", "ref_text": REF_TEXTS[1]},
           "audio": True},
          {"fields": {"language": "english", "x_vector_only_mode": "true"},
           "audio": True},
          {"fields": {"language": "english"}}],
    "M": [{"fields": {"language": "english", "instruct": i}}
          for i in INSTRUCTS],
    "P": [{"fields": {"ref_text": REF_TEXTS[0]}, "audio": True},
          {"fields": {"ref_text": REF_TEXTS[1]}, "audio": True},
          {"fields": {}, "audio": True},
          {"fields": {}}],
    # speech to speech: two uploads without text, then two text streams
    "Q": [{"fields": {}, "audio": True, "text": ""}] * 2
    + [{"fields": {}}] * 2,
}
REQUESTS["R"] = REQUESTS["TPG"] = REQUESTS["Q"]
REQUESTS["S"] = REQUESTS["Q"]
REQUESTS["T"] = [{"fields": {}, "audio": True, "text": ""}, {"fields": {}}]
# Chatterbox's voice clones speak their text in the upload's voice
REQUESTS["V"] = [{"fields": {}}] * 2 + [{"fields": {}, "audio": True}] * 2
# Zonos speaks the text in the voice of the upload's speaker vector
REQUESTS["X"] = [{"fields": {}, "audio": True}] * 2 + [{"fields": {}}] * 2
#: the reference clip L uploads: 3 s at 24 kHz
REF_SAMPLES = 72000
#: the prompt WAVs of the synthetic sesame/csm-1b snapshot: 0.96 s each
CSM_PROMPT_SAMPLES = 23040
#: the requests of a wave that use the text-stream protocol (G: 2 of 4; the
#: rest POST /generate)
TEXT_STREAMS = {"G": 2}
#: the step kinds that run the LM (H: every detokenize replay after them)
LM_KINDS = ("prefill", "decode", "decode_multi", "decode_multi_detok",
            "cold_chain")


def mimi_frames(n_samples: int, ratios=(8, 6, 5, 4)) -> int:
    """Frames the Mimi encoder makes of ``n_samples``: each strided causal
    conv pads its last frame whole (ceil), then the x2 downsample."""
    n = n_samples
    for r in (*reversed(ratios), 2):
        n = -(-n // r)
    return n


def synth_wav(n_samples: int, seed: int) -> bytes:
    """A 24 kHz mono PCM16 WAV of a voiced-like signal (harmonics of a
    gliding pitch under a syllable-rate envelope)."""
    import io
    import wave

    import numpy as np

    t = np.arange(n_samples) / SAMPLE_RATE
    f0 = 110.0 + 30.0 * seed + 20.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t) ** 2
    pcm = (x / np.abs(x).max() * 12000).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def s3_tokens(n_samples: int) -> int:
    """S3 v2 tokens of a 24 kHz clip: resampled to 16 kHz, Whisper frames
    at hop 160 less the dropped last one, two stride-2 convs (pad 1, k 3);
    at most 150 in a prompt."""
    n = (int(round(n_samples * 16000 / SAMPLE_RATE)) // 160 + 1) - 1
    for _ in range(2):
        n = (n - 1) // 2 + 1
    return min(n, 150)


#: the Whisper-VQ weights a GLM run's daemon serves, where they are not
#: the random init from ``VQ_SEED`` (R: the tokenizer snapshot's), and the
#: speech tokens of the uploaded WAV under each run's weights
GLM_VQ_PARAMS: dict = {}
_GLM_TOKENS: dict = {}
#: the speech tokens of the 3 s upload: 300 mel frames at 16 kHz / 8
GLM_UPLOAD_TOKENS = 38


def glm_speech_tokens(config: str):
    """The speech tokens the daemon of GLM run ``config`` makes of the
    uploaded WAV: the same Whisper-VQ weights (the random init from
    ``VQ_SEED``, or the snapshot's) through the same encoder on the card,
    in this process."""
    if config not in _GLM_TOKENS:
        import tempfile

        import torch

        from vox_serve_tpu_torch.encoders.whisper_exact import (
            GLMVQConfig, init_glm_vq_params)
        from vox_serve_tpu_torch.models.backbone import seeded_generator
        from vox_serve_tpu_torch.models.glm_voice import (
            VQ_SEED, encode_speech_tokens)

        dev = torch.device("cuda")
        params = GLM_VQ_PARAMS.get(config) or init_glm_vq_params(
            seeded_generator(dev, VQ_SEED), GLMVQConfig(), dev)
        with tempfile.NamedTemporaryFile(suffix=".wav") as f:
            f.write(synth_wav(REF_SAMPLES, seed=0))
            f.flush()
            toks = encode_speech_tokens(params, GLMVQConfig(), f.name, dev)
        if len(toks) != GLM_UPLOAD_TOKENS:
            raise AssertionError(f"[{config}] {len(toks)} speech tokens of "
                                 f"the 3 s upload, expected "
                                 f"{GLM_UPLOAD_TOKENS}")
        _GLM_TOKENS[config] = toks
    return _GLM_TOKENS[config]


def expected_prompt_tokens(config: str, i: int, text: str) -> int:
    """The prompt length request ``i`` of a run must have under the
    char-level dev tokenizer (every snapshot here ships none): Qwen3's role
    rows (3), think prefix with the English id (4), the speaker x-vector
    row (Base), tts_bos, the text, tts_eos + codec_bos; an ICL clone adds
    its reference transcript and the reference's codec frames; VoiceDesign
    adds its instruct template and has no speaker row. CSM: the default
    two-speaker context ("[spk]transcript" rows, each prompt WAV's Mimi
    frames and an EOS frame), then "[0]text". CosyVoice2: [sos] + the
    reference transcript + the text + [task_id] + the reference's S3 v2
    tokens. GLM-4-Voice: the chat template in text mode, or in audio mode
    with the upload's speech tokens as ``<|audio_k|>`` strings.
    Step-Audio 2: its chat template around the text, or around
    ``<audio_start>``, one marker per adaptor row and ``<audio_end>``.
    Chatterbox: 34 conditioning rows, [start text] + the normalized text
    (``[SPACE]`` for each space) + [stop text], the start-speech row; an
    upload changes the conditioning rows, not their count. Zonos: BOS, the
    text's phonemes (without espeak the text itself, its digits spelled
    out: these prompts have none), EOS and 6 conditioning rows (speaker,
    emotion, fmax, pitch_std, speaking_rate, language); an upload changes
    the speaker row, not the count."""
    if family(config) == "zonos":
        if any(ch.isdigit() for ch in text):
            raise ValueError(f"a Zonos prompt with digits: {text!r}")
        return len(text) + 2 + 6
    if family(config) == "chatterbox":
        from vox_serve_tpu_torch.models.chatterbox import COND_LEN, ChatterboxLM

        text = ChatterboxLM._punc_norm(text).replace(" ", "[SPACE]")
        return COND_LEN + len(text) + 3
    if family(config) == "step":
        from vox_serve_tpu_torch.models.step_audio_2 import (PROMPT_POST,
                                                             PROMPT_PRE)

        if REQUESTS[config][i].get("audio"):
            return (len(PROMPT_PRE + "<audio_start><audio_end>" + PROMPT_POST)
                    + step_upload_rows())
        return len(PROMPT_PRE + text + PROMPT_POST)
    if family(config) == "glm":
        from vox_serve_tpu_torch.models.glm_voice import glm_prompt_text

        if REQUESTS[config][i].get("audio"):
            return len(glm_prompt_text(None, glm_speech_tokens(config)))
        return len(glm_prompt_text(text))
    if family(config) == "cosyvoice2":
        req = REQUESTS[config][i]
        return (2 + len(req["fields"].get("ref_text", "")) + len(text)
                + (s3_tokens(REF_SAMPLES) if req.get("audio") else 0))
    if family(config) == "csm":
        from vox_serve_tpu_torch.models.csm import CSMLM

        ctx = sum(len(f"[{spk}]{t}") + mimi_frames(CSM_PROMPT_SAMPLES) + 1
                  for spk, t in enumerate(CSMLM._PROMPT_TEXTS))
        return ctx + len(f"[0]{text}")
    fields = REQUESTS[config][i]["fields"]
    n = 3 + 4 + 1 + len(text) + 2
    if "instruct" in fields:
        return n + len(f"<|im_start|>user\n{fields['instruct']}"
                       "<|im_end|>\n")
    n += 1  # the x-vector row
    if "ref_text" in fields:
        n += len(fields["ref_text"]) + mimi_frames(REF_SAMPLES)
    return n


def step_upload_rows() -> int:
    """The adaptor rows (and ``<audio>`` markers) of the 3 s upload at 16
    kHz: 302 mel frames -> 151 -> 75 -> 18."""
    from vox_serve_tpu_torch.models.step_audio_2 import step_audio_rows

    return step_audio_rows(REF_SAMPLES * 16000 // SAMPLE_RATE)


#: the runs whose prompts are held to ``expected_prompt_tokens``
PROMPT_LENGTHS = ("L", "M", "N", "P", "Q", "R", "S", "T", "U", "V", "W",
                  "TPG",
                  "X")


def check_prompt_lengths(config: str, stats: dict, out: dict) -> None:
    """Each stream's prompt, as the daemon counted it, is exactly as long
    as its variant's rows: L's ICL prompts hold the reference's frames, M's
    have no speaker row, N's carry the default context."""
    done = {r["request_id"][:8]: r for r in stats["requests"]}
    got = []
    for i, st in enumerate(out["streams"]):
        want = expected_prompt_tokens(config, i, PROMPTS[i])
        n = done[st["rid8"]]["prompt_tokens"]
        if n != want:
            raise AssertionError(f"[{config}] stream {i}: a prompt of {n} "
                                 f"tokens, its rows give {want}")
        got.append(n)
    log(f"[{config}] prompt lengths {got} as their rows give"
        + (f" (ICL: {mimi_frames(REF_SAMPLES)} reference frames each)"
           if config == "L" else "")
        + (f" (clones: {s3_tokens(REF_SAMPLES)} S3 v2 tokens each)"
           if config == "P" else "")
        + (f" (speech uploads: {GLM_UPLOAD_TOKENS} Whisper-VQ tokens each, "
           f"{[int(t) for t in _GLM_TOKENS[config][:8]]}...)"
           if config in _GLM_TOKENS else "")
        + (f" (speech uploads: {step_upload_rows()} adaptor rows each)"
           if family(config) == "step" else ""))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def http_get(port: int, path: str) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", path)
        return conn.getresponse().status
    finally:
        conn.close()


def multipart(fields: dict, files: dict) -> tuple[bytes, str]:
    """A multipart/form-data body: text ``fields`` and ``files`` (name ->
    (filename, bytes)); returns (body, content type)."""
    boundary = f"vox{time.monotonic_ns()}"
    parts = []
    for k, v in fields.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"\r\n\r\n{v}\r\n'.encode())
    for k, (fname, data) in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                     f'name="{k}"; filename="{fname}"\r\nContent-Type: '
                     'audio/wav\r\n\r\n'.encode() + data + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


def stream_generate(port: int, text: str, out: dict,
                    fields: dict | None = None,
                    audio: bytes | None = None) -> None:
    """POST /generate (urlencoded, or multipart with an uploaded ``audio``
    WAV) and read the streamed WAV, recording TTFA and wall time."""
    form = {"text": text, **(fields or {"speaker": "ryan",
                                        "language": "english"})}
    if audio is None:
        body = urllib.parse.urlencode(form)
        ctype = "application/x-www-form-urlencoded"
    else:
        body, ctype = multipart(form, {"audio": ("reference.wav", audio)})
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate", body=body,
                     headers={"Content-Type": ctype})
        resp = conn.getresponse()
        out["status"] = resp.status
        # "attachment; filename=stream_<first 8 of the request id>.wav"
        disp = resp.getheader("Content-Disposition") or ""
        out["rid8"] = disp.rsplit("stream_", 1)[-1].split(".")[0]
        data = b""
        while True:
            chunk = resp.read1(65536)
            if not chunk:
                break
            data += chunk
            if "ttfa_s" not in out and len(data) > 44:
                out["ttfa_s"] = time.perf_counter() - t0
        out["wall_s"] = time.perf_counter() - t0
        out["body"] = data
    except Exception as e:  # recorded and raised by the caller
        out["error"] = repr(e)
    finally:
        conn.close()


def _post_form(port: int, path: str, fields: dict) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=urllib.parse.urlencode(fields),
                     headers={"Content-Type":
                              "application/x-www-form-urlencoded"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def stream_text_input(port: int, text: str, out: dict) -> None:
    """The text-stream protocol: start a session, read its audio stream
    while three pieces of the text are sent ~150 ms apart (the first one
    past the scheduler's 20-character buffer), then end it. TTFA runs from
    the first piece to the first PCM byte."""
    cut = text.index(" ", 20)
    mid = (cut + len(text)) // 2
    pieces = [text[:cut], text[cut:mid], text[mid:]]
    reader: dict = {}
    try:
        status, body = _post_form(port, "/generate/stream/start",
                                  {"speaker": "ryan", "language": "english"})
        if status != 200:
            raise RuntimeError(f"stream start: status {status}")
        rid = json.loads(body)["request_id"]
        out["rid8"] = rid[:8]

        def read_audio():
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            try:
                conn.request("GET", f"/generate/stream/{rid}/audio")
                resp = conn.getresponse()
                reader["status"] = resp.status
                data = b""
                while True:
                    chunk = resp.read1(65536)
                    if not chunk:
                        break
                    data += chunk
                    if "t_first" not in reader and len(data) > 44:
                        reader["t_first"] = time.perf_counter()
                reader["body"] = data
                reader["t_end"] = time.perf_counter()
            except Exception as e:
                reader["error"] = repr(e)
            finally:
                conn.close()

        th = threading.Thread(target=read_audio)
        th.start()
        t0 = time.perf_counter()
        for i, piece in enumerate(pieces):
            if i:
                time.sleep(0.15)
            status, _ = _post_form(port, f"/generate/stream/{rid}/text",
                                   {"text": piece})
            if status != 200:
                raise RuntimeError(f"stream text: status {status}")
        status, _ = _post_form(port, f"/generate/stream/{rid}/end", {})
        if status != 200:
            raise RuntimeError(f"stream end: status {status}")
        th.join(timeout=900)
        if "error" in reader or "t_first" not in reader:
            raise RuntimeError(f"audio stream: {reader.get('error')} status "
                               f"{reader.get('status')}")
        out.update(status=reader["status"], body=reader["body"],
                   ttfa_s=reader["t_first"] - t0,
                   wall_s=reader["t_end"] - t0, text_stream=True)
    except Exception as e:  # recorded and raised by the caller
        out["error"] = repr(e)


def serve_wave(config: str, port: int, prompts: list[str],
               text_streams: int = 0) -> tuple:
    """Stream ``prompts`` concurrently, the first ``text_streams`` of them
    through the text-stream protocol; check every response's PCM and
    return (results, audio units (frames or windows), wall seconds)."""
    import numpy as np

    spec = MODELS[family(config)]
    unit, per = spec["unit"], spec["unit_samples"]
    if family(config) in OVERLAP_WINDOWS:
        max_samples = overlap_pcm_samples(max_tokens(config),
                                          *OVERLAP_WINDOWS[family(config)])
    elif family(config) == "glm":  # a 100-token window: 689 frames
        max_samples = -(-max_tokens(config) // 100) * glm_window_samples(100)
    else:
        max_samples = max_tokens(config) * per

    results = [{} for _ in prompts]
    reqs = REQUESTS.get(config) or [
        {"fields": FORM.get(family(config))}] * len(prompts)
    ref = synth_wav(REF_SAMPLES, seed=0)
    threads = [threading.Thread(
        target=stream_text_input if i < text_streams else stream_generate,
        args=(port, p, r) if i < text_streams else (
            port, reqs[i].get("text", p), r, reqs[i].get("fields"),
            ref if reqs[i].get("audio") else None))
        for i, (p, r) in enumerate(zip(prompts, results))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    frames = 0.0
    for i, r in enumerate(results):
        if "error" in r or r.get("status") != 200:
            raise RuntimeError(f"request {i} failed: {r.get('error')} "
                               f"status {r.get('status')}")
        body = r["body"]
        if body[:4] != b"RIFF":
            raise AssertionError(f"request {i}: no WAV header")
        pcm = np.frombuffer(body[44:], dtype=np.int16)
        if pcm.size == 0 or (len(body) - 44) % 2:
            raise AssertionError(f"request {i}: empty or odd PCM")
        if pcm.size > max_samples:
            raise AssertionError(f"request {i}: {pcm.size} samples > "
                                 f"the budget's {max_samples}")
        if not np.isfinite(pcm.astype(np.float32)).all():
            raise AssertionError(f"request {i}: non-finite PCM")
        r["samples"] = pcm.size
        r["frames"] = pcm.size / per
        frames += r["frames"]
        how = "text stream" if r.get("text_stream") else "/generate"
        log(f"[{config}] {len(prompts)}-stream wave, request {i} ({how}): "
            f"{pcm.size} samples ({r['frames']:.1f} {unit}, "
            f"{pcm.size / SAMPLE_RATE:.2f} s audio, peak "
            f"{int(np.abs(pcm.astype(np.int32)).max())}), TTFA "
            f"{r['ttfa_s'] * 1e3:.1f} ms, wall {r['wall_s']:.2f} s")
    return results, frames, wall


def end_to_end(card: str, config: str, hub: str | None = None) -> dict:
    """Serve one configuration over HTTP; returns the daemon's launch
    counts, the 4-stream wave's frames/s and TTFA median, and the solo
    stream's TTFA (F), after checking what it served and which kernels and
    graphs ran. ``hub``: the Hugging Face hub cache the daemon resolves
    checkpoints in (``HF_HUB_CACHE``; L, M and N)."""
    if config == PROFILE_RUN and config not in CONFIGS:
        CONFIGS[config] = profile_config()
    flags, env_extra, served, must_run = CONFIGS[config]
    model = MODEL_OF.get(config, "qwen3-tts")
    fam = family(config)
    OUT.mkdir(exist_ok=True)
    port = free_port()
    stats_path = OUT / f"chip_smoke_server_stats_{config}.json"
    for path in (stats_path, Path(f"{stats_path}.rank1")):
        if path.exists():
            path.unlink()
    log_path = OUT / f"chip_smoke_server_{config}.log"
    server_log = open(log_path, "w")
    if config == PROFILE_RUN:  # the profile's batch, pages and lattices
        flags = []
        sizes = []
    else:
        flags = pinned(flags)
        sizes = ["--device", "cuda", "--max-batch-size", "4",
                 "--max-num-pages", "2048"]
    cmd = [sys.executable, "-m", "vox_serve_tpu_torch.launch",
           "--model", model, *sizes,
           "--host", "127.0.0.1", "--port", str(port),
           "--max-tokens", str(max_tokens(config)), "--seed", "0",
           "--socket-suffix", f"_smoke{port}",
           "--stats-file", str(stats_path), *flags]
    env = {k: v for k, v in os.environ.items()
           if k not in ("VOX_FUSED_RESUNIT", "VOX_KV_COMBINED",
                        "HF_HUB_CACHE")}
    env.update(env_extra)
    if hub is not None:
        env["HF_HUB_CACHE"] = hub
    t_start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=server_log, env=env,
                            stderr=subprocess.STDOUT, start_new_session=True)
    out: dict = {}
    try:
        deadline = time.monotonic() + 600
        while True:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited ({proc.returncode})")
            try:
                if http_get(port, "/health") == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise RuntimeError("server not healthy within 600 s")
            time.sleep(0.5)
        out["ready_s"] = time.perf_counter() - t_start
        log(f"[{config}] {' '.join(flags)} "
            f"{' '.join(f'{k}={v}' for k, v in env_extra.items())} server "
            f"ready in {out['ready_s']:.1f} s")
        waves = ((served["max_batch_size"],) if config == PROFILE_RUN
                 else WAVES.get(config, (len(PROMPTS),)))
        for n in waves:
            prompts = [PROMPTS[i % len(PROMPTS)] for i in range(n)]
            results, frames, wall = serve_wave(
                config, port, prompts, TEXT_STREAMS.get(config, 0))
            ttfa = sorted(r["ttfa_s"] for r in results)
            if n == 1:
                out["solo_ttfa_s"] = ttfa[0]
                continue
            out.update(frames=frames, wall=wall,
                       frames_per_s=frames / wall, ttfa=ttfa,
                       ttfa_median_s=(ttfa[(n - 1) // 2] + ttfa[n // 2]) / 2,
                       streams=[{k: r.get(k) for k in ("rid8", "samples",
                                                        "ttfa_s", "wall_s")}
                                for r in results])
            if TEXT_STREAMS.get(config):
                out["text_stream_ttfa"] = [r["ttfa_s"] for r in results
                                           if r.get("text_stream")]
                out["generate_ttfa"] = [r["ttfa_s"] for r in results
                                        if not r.get("text_stream")]
    except Exception:
        server_log.flush()
        tail = log_path.read_text().splitlines()[-80:]
        print("server log (last lines):\n" + "\n".join(tail),
              file=sys.stderr)
        raise
    finally:
        # SIGTERM to the launcher: it terminates its scheduler daemon, which
        # writes the stats file on the way out
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
        # the daemon is in the same session: make sure nothing survives
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        server_log.close()

    for _ in range(100):
        if stats_path.exists() and stats_path.stat().st_size:
            break
        time.sleep(0.1)
    stats = json.loads(stats_path.read_text())
    out["launches"] = stats["launches"]
    out["backbone_bytes"] = stats["backbone_bytes"]
    out["probe_ms"] = stats["steps"]["probe_ms"]
    if config == "DP":
        # the streams' checks read both ranks' completed requests
        stats["requests"] += check_dp_run(
            config, Path(f"{stats_path}.rank1"), stats)
    check_run(config, card, stats, out)
    if config == PROFILE_RUN:
        check_profile_run(config, stats, out)
    elif config == "DG":
        check_split_run(config, stats)
    elif config in TP_RUNS:
        check_tp_run(config, stats, out)
    if fam == "step":
        check_step_windows(config, stats, out)
    elif fam in FEATURE_ROW_CODECS:
        check_feature_row_windows(config, stats, out)
    elif fam in OVERLAP_WINDOWS:
        check_overlap_windows(config, stats, out)
    elif fam == "glm":
        check_glm_windows(config, stats, out)
    else:
        check_frame_streams(config, stats, out, fam == "csm")
    if config in PROMPT_LENGTHS:
        check_prompt_lengths(config, stats, out)
    return out


def frame_pcm_samples(n_tokens: int, ends: set) -> int:
    """The PCM a stream of ``n_tokens`` codec frames (Qwen3, CSM) must
    emit: windows tile the frames contiguously, 1920 samples a frame, and a
    last window holding fewer frames than its length keeps int(samples *
    (valid - 0.5) / length) (the JAX worker's ``_resolve_detok``), half a
    frame less. ``ends``: where windows end."""
    fs = FRAME_WINDOWS[1]
    return fs * n_tokens - (0 if n_tokens in ends else fs // 2)


def check_frame_streams(config: str, stats: dict, out: dict,
                        verbose: bool) -> None:
    """Each stream's PCM is exactly what the trim rule gives for the frames
    its daemon generated (a window dropped or emitted twice fails).
    Without the first-chunk ramp windows end every 10 frames; with it the
    ramp's mini windows (3, then 3 or 6 frames, unless the scheduler hands
    a stream to full windows early) end first, so a stream's last window is
    whole or trimmed by half a frame and both lengths are accepted.
    ``verbose`` (CSM) prints each stream's finish reason, TTFA and frames/s
    against real time (12.5 frames/s), and the decode and detokenize replay
    times."""
    interval, fs = FRAME_WINDOWS
    ramp = stats["first_chunk_frames"]
    done = {r["request_id"][:8]: r for r in stats["requests"]}
    for i, st in enumerate(out["streams"]):
        req = done.get(st["rid8"])
        if req is None:
            raise AssertionError(f"[{config}] stream {i} ({st['rid8']}) not "
                                 f"among the daemon's requests {list(done)}")
        n = req["audio_tokens"]
        want = {frame_pcm_samples(n, set(range(0, n + 1, interval)))}
        if ramp:
            want |= {fs * n, fs * n - fs // 2}
        if n <= 0 or st["samples"] not in want:
            raise AssertionError(
                f"[{config}] stream {i}: {st['samples']} samples for {n} "
                f"frames, the trim rule gives {sorted(want)}")
        if verbose:
            log(f"[{config}] stream {i} ({st['rid8']}): {n} audio tokens "
                f"({req['finish_reason']}) -> {st['samples']} samples (rule:"
                f" {sorted(want)}); TTFA {st['ttfa_s'] * 1e3:.1f} ms, "
                f"{st['samples'] / fs / st['wall_s']:.2f} frames/s (real "
                "time 12.50)")
    if not verbose:
        frames = [done[st["rid8"]]["audio_tokens"] for st in out["streams"]]
        log(f"[{config}] every stream's PCM follows the trim rule for its "
            f"frames {frames}")
        return
    probe = stats["steps"]["probe_ms"]
    ph = stats["phase_stats"]
    det_t, det_n = ph.get("detokenize", (0.0, 0))
    log(f"[{config}] CSM-1B: TTFA median {out['ttfa_median_s'] * 1e3:.1f} ms;"
        f" {out['frames_per_s']:.2f} frames/s aggregate over 4 streams (real "
        f"time: 12.50 per stream, 50.00 for 4); decode replay ms (probe) "
        + str({k: v for k, v in probe.items() if k.startswith("decode")})
        + "; detokenize replay ms (probe) "
        + str({k: v for k, v in probe.items() if k.startswith("detok ")})
        + f"; detokenize wall {det_t / max(det_n, 1) * 1e3:.2f} ms per call")


def check_overlap_windows(config: str, stats: dict, out: dict) -> None:
    """Each stream of an overlap codec (Orpheus, CosyVoice2) emits exactly
    the PCM the overlap rule gives for the audio tokens its daemon
    generated (a window dropped or emitted twice fails), at least
    ``MIN_WINDOWS`` windows each; prints the run's TTFA, windows/s against
    real time and the decode and detokenize replay times, and for
    CosyVoice2 the detokenize graphs' capture seconds and pool growth."""
    fam = family(config)
    interval, overlap, window = OVERLAP_WINDOWS[fam]
    done = {r["request_id"][:8]: r for r in stats["requests"]}
    for i, st in enumerate(out["streams"]):
        req = done.get(st["rid8"])
        if req is None:
            raise AssertionError(f"[{config}] stream {i} ({st['rid8']}) not "
                                 f"among the daemon's requests {list(done)}")
        want = overlap_pcm_samples(req["audio_tokens"], interval, overlap,
                                   window)
        if st["samples"] != want:
            raise AssertionError(
                f"[{config}] stream {i}: {st['samples']} samples for "
                f"{req['audio_tokens']} audio tokens, the overlap rule gives "
                f"{want}")
        if want < MIN_WINDOWS[fam] * window:
            raise AssertionError(f"[{config}] stream {i}: "
                                 f"{want / window:.2f} windows, expected at "
                                 f"least {MIN_WINDOWS[fam]}")
        log(f"[{config}] stream {i} ({st['rid8']}): {req['audio_tokens']} "
            f"audio tokens ({req['finish_reason']}) -> {st['samples']} "
            f"samples = {st['samples'] / window:.2f} windows (overlap rule: "
            f"{want}); TTFA {st['ttfa_s'] * 1e3:.1f} ms, "
            f"{st['samples'] / window / st['wall_s']:.2f} windows/s")
    realtime = SAMPLE_RATE / window
    steps = stats["steps"]
    probe = steps["probe_ms"]
    dec = {k: v for k, v in probe.items() if k.startswith("decode ")}
    det = {k: v for k, v in probe.items() if k.startswith("detok ")}
    ph = stats["phase_stats"]
    det_t, det_n = ph.get("detokenize", (0.0, 0))
    name = {"orpheus": "Orpheus-3B", "cosyvoice2": "CosyVoice2-0.5B"}[fam]
    log(f"[{config}] {name}: TTFA median {out['ttfa_median_s'] * 1e3:.1f}"
        f" ms; {out['frames_per_s']:.2f} windows/s aggregate over 4 streams "
        f"(real time: {realtime:.2f} per stream, {4 * realtime:.2f} for 4); "
        f"decode replay ms (probe) {dec}; detokenize replay ms (probe) {det};"
        f" detokenize wall {det_t / max(det_n, 1) * 1e3:.2f} ms per call")
    if fam == "cosyvoice2":
        cap, mib = steps["capture_s_by_kind"], steps["pool_mib_by_kind"]
        log(f"[{config}] detokenize graphs (flow + HiFT): "
            f"{sum(1 for g in steps['graphs'] if g[0] == 'detok')} captured "
            f"in {cap.get('detok', 0.0):.2f} s, the shared pool grew "
            f"{mib.get('detok', 0.0):.1f} MiB while they were captured; "
            f"capture s by kind {cap}; pool MiB by kind {mib}; replays per "
            f"detokenize length " + str({
                k: c["replays"] for k, c in steps["captured"].items()
                if k.startswith("detok ")}))


def check_glm_windows(config: str, stats: dict, out: dict) -> None:
    """Each GLM-4-Voice stream emits exactly the PCM the trim rule gives
    over the windows its daemon reports (``window_pcm_samples``: they
    must tile the stream's audio tokens), and every stream that ran to its
    length cap reached two full windows (50 audio tokens), so the HiFT
    cache carried across windows; a stream that sampled a stop id earlier
    is printed. Prints TTFA (under random weights: ~240 decode steps per
    window), windows/s against real time, the decode and detokenize replay
    times, the detokenize graphs' capture and the init memory."""
    done = {r["request_id"][:8]: r for r in stats["requests"]}
    window = glm_window_samples(GLM_INTERVAL)
    for i, st in enumerate(out["streams"]):
        req = done.get(st["rid8"])
        if req is None:
            raise AssertionError(f"[{config}] stream {i} ({st['rid8']}) not "
                                 f"among the daemon's requests {list(done)}")
        n, wins = req["audio_tokens"], req["detok_windows"]
        want = window_pcm_samples(n, wins)
        if st["samples"] != want:
            raise AssertionError(
                f"[{config}] stream {i}: {st['samples']} samples for {n} "
                f"audio tokens over windows {wins}, the trim rule gives "
                f"{want}")
        short = n < MIN_GLM_WINDOWS * GLM_INTERVAL
        if short and req["finish_reason"] != "stop":
            raise AssertionError(f"[{config}] stream {i}: {n} audio tokens "
                                 f"({req['finish_reason']}), fewer than "
                                 f"{MIN_GLM_WINDOWS} full windows")
        early = ", sampled a stop id early" if short else ""
        log(f"[{config}] stream {i} ({st['rid8']}): {n} audio tokens after "
            f"a {req['prompt_tokens']}-token prompt ({req['finish_reason']}"
            f"{early}) -> windows (start, length) {wins} -> {st['samples']} "
            "samples "
            f"= {st['samples'] / window:.2f} windows at 22,050 Hz (rule: "
            f"{want}); TTFA {st['ttfa_s'] * 1e3:.1f} ms, "
            f"{st['samples'] / window / st['wall_s']:.3f} windows/s")
    if all(done[st["rid8"]]["audio_tokens"] < MIN_GLM_WINDOWS * GLM_INTERVAL
           for st in out["streams"]):
        raise AssertionError(f"[{config}] no stream reached "
                             f"{MIN_GLM_WINDOWS} windows")
    steps = stats["steps"]
    probe = steps["probe_ms"]
    dec = {k: v for k, v in probe.items() if k.startswith("decode ")}
    det = {k: v for k, v in probe.items() if k.startswith("detok ")}
    ph = stats["phase_stats"]
    det_t, det_n = ph.get("detokenize", (0.0, 0))
    pp_t, pp_n = ph.get("preprocess", (0.0, 0))
    cap, mib = steps["capture_s_by_kind"], steps["pool_mib_by_kind"]
    realtime = 22050 / window
    log(f"[{config}] GLM-4-Voice-9B (random LM weights: TTFA counts ~240 "
        f"decode steps a window): TTFA median "
        f"{out['ttfa_median_s'] * 1e3:.1f} ms; {out['frames_per_s']:.3f} "
        f"windows/s aggregate over 4 streams (real time: {realtime:.3f} per "
        f"stream); decode replay ms (probe) {dec}; detokenize replay ms "
        f"(probe) {det}; detokenize wall {det_t / max(det_n, 1) * 1e3:.2f} "
        f"ms per call; preprocess wall (Whisper-VQ on the card for uploads) "
        f"{pp_t / max(pp_n, 1) * 1e3:.1f} ms x {pp_n}; detokenize graphs "
        f"(flow + HiFT): "
        f"{sum(1 for g in steps['graphs'] if g[0] == 'detok')} captured in "
        f"{cap.get('detok', 0.0):.2f} s, pool +{mib.get('detok', 0.0):.1f} "
        f"MiB; capture s by kind {cap}; init memory {stats['init_memory_gb']}"
        " GB")


def check_step_windows(config: str, stats: dict, out: dict) -> None:
    """Each Step-Audio-2 stream emits exactly the PCM the overlap rule
    gives for the audio tokens its daemon reports (28-token windows every
    25 tokens, 24,000 samples each, the last trimmed), every stream that
    ran to its length cap reached ``MIN_WINDOWS`` full windows (a stream
    that sampled a stop id is held to the rule alone, and printed), and
    each upload's prompt carried its adaptor rows: the daemon counts the
    prompt rows that took a feature row (``feature_rows``), which must be
    the upload's 18 (0 for a text stream). Prints TTFA (random weights:
    ~630 decode steps to the first window), windows/s against real time,
    the decode and detokenize replay times, the preprocess wall (the
    encoder on the card), the detokenize graphs' capture and the init
    memory."""
    interval, overlap, window = OVERLAP_WINDOWS["step"]
    done = {r["request_id"][:8]: r for r in stats["requests"]}
    rows = step_upload_rows()
    full = []
    for i, st in enumerate(out["streams"]):
        req = done.get(st["rid8"])
        if req is None:
            raise AssertionError(f"[{config}] stream {i} ({st['rid8']}) not "
                                 f"among the daemon's requests {list(done)}")
        n = req["audio_tokens"]
        want = overlap_pcm_samples(n, interval, overlap, window)
        if st["samples"] != want:
            raise AssertionError(
                f"[{config}] stream {i}: {st['samples']} samples for {n} "
                f"audio tokens, the overlap rule gives {want}")
        upload = bool(REQUESTS[config][i].get("audio"))
        if req["feature_rows"] != (rows if upload else 0):
            raise AssertionError(
                f"[{config}] stream {i}: {req['feature_rows']} prompt rows "
                f"took a feature row, expected {rows if upload else 0}")
        short = want < MIN_WINDOWS["step"] * window
        if short and req["finish_reason"] != "stop":
            raise AssertionError(f"[{config}] stream {i}: {n} audio tokens "
                                 f"({req['finish_reason']}), fewer than "
                                 f"{MIN_WINDOWS['step']} full windows")
        full.append(not short)
        log(f"[{config}] stream {i} ({st['rid8']}, "
            f"{'upload' if upload else 'text'}): {n} audio tokens after a "
            f"{req['prompt_tokens']}-token prompt with "
            f"{req['feature_rows']} spliced rows ({req['finish_reason']}"
            f"{', sampled a stop id early' if short else ''}) -> "
            f"{st['samples']} samples = {st['samples'] / window:.2f} windows"
            f" at 24,000 Hz (overlap rule: {want}; windows "
            f"{req['detok_windows']}); TTFA {st['ttfa_s'] * 1e3:.1f} ms, "
            f"{st['samples'] / window / st['wall_s']:.3f} windows/s")
    if not any(full):
        raise AssertionError(f"[{config}] no stream reached "
                             f"{MIN_WINDOWS['step']} windows")
    steps = stats["steps"]
    probe = steps["probe_ms"]
    dec = {k: v for k, v in probe.items() if k.startswith("decode ")}
    det = {k: v for k, v in probe.items() if k.startswith("detok ")}
    pre = {k: v for k, v in probe.items() if k.startswith("prefill ")}
    ph = stats["phase_stats"]
    det_t, det_n = ph.get("detokenize", (0.0, 0))
    pp_t, pp_n = ph.get("preprocess", (0.0, 0))
    cap, mib = steps["capture_s_by_kind"], steps["pool_mib_by_kind"]
    log(f"[{config}] Step-Audio-2-mini (random LM weights: TTFA counts ~630 "
        f"decode steps to the first window): TTFA median "
        f"{out['ttfa_median_s'] * 1e3:.1f} ms; {out['frames_per_s']:.3f} "
        f"windows/s aggregate over {len(out['streams'])} streams (real time:"
        f" 1.000 per stream); decode replay ms (probe) {dec}; prefill replay "
        f"ms (probe) {pre}; detokenize replay ms (probe) {det}; detokenize "
        f"wall {det_t / max(det_n, 1) * 1e3:.2f} ms per call; preprocess "
        f"wall (the audio encoder + adaptor on the card for uploads) "
        f"{pp_t / max(pp_n, 1) * 1e3:.1f} ms x {pp_n}; detokenize graphs "
        f"(DiT flow + HiFT): "
        f"{sum(1 for g in steps['graphs'] if g[0] == 'detok')} captured in "
        f"{cap.get('detok', 0.0):.2f} s, pool +{mib.get('detok', 0.0):.1f} "
        f"MiB; capture s by kind {cap}; init memory {stats['init_memory_gb']}"
        " GB")


#: the families whose every prompt row is a host feature row: their name
#: and what their detokenize graphs hold
FEATURE_ROW_CODECS = {"chatterbox": ("Chatterbox", "flow + HiFT + watermark"),
                      "zonos": ("Zonos", "delay revert + DAC + 24 kHz "
                                "resample")}


def check_feature_row_windows(config: str, stats: dict, out: dict) -> None:
    """Each stream of a feature-row family (Chatterbox, Zonos) emits
    exactly the PCM the overlap rule gives for the audio tokens its daemon
    reports (Chatterbox: 25-token windows every 22 tokens, 21,120 samples
    each; Zonos: 50 every 41, 11,425; the last trimmed); every stream that
    ran to its length cap reached ``MIN_WINDOWS`` full windows (a stream
    that sampled the stop id is held to the rule alone, and printed), and
    some stream did (Zonos: some stream decoded ``RUN_MIN_WINDOWS``
    windows); every prompt row took its feature row (``feature_rows`` =
    the prompt); no upload fell back (the daemon's log names no failed
    speaker extraction). Prints TTFA, windows/s against real time, the
    decode, prefill and detokenize replay times, the preprocess wall (V's
    uploads: S3 v2 and CAMPPlus on the card; X's: the speaker net), the
    detokenize graphs' capture, the watermark and the init memory."""
    fam = family(config)
    name, holds = FEATURE_ROW_CODECS[fam]
    interval, overlap, window = OVERLAP_WINDOWS[fam]
    done = {r["request_id"][:8]: r for r in stats["requests"]}
    full = []
    for i, st in enumerate(out["streams"]):
        req = done.get(st["rid8"])
        if req is None:
            raise AssertionError(f"[{config}] stream {i} ({st['rid8']}) not "
                                 f"among the daemon's requests {list(done)}")
        n = req["audio_tokens"]
        want = overlap_pcm_samples(n, interval, overlap, window)
        if st["samples"] != want:
            raise AssertionError(
                f"[{config}] stream {i}: {st['samples']} samples for {n} "
                f"audio tokens, the overlap rule gives {want}")
        if req["feature_rows"] != req["prompt_tokens"]:
            raise AssertionError(
                f"[{config}] stream {i}: {req['feature_rows']} of "
                f"{req['prompt_tokens']} prompt rows took a feature row")
        short = want < MIN_WINDOWS[fam] * window
        if short and req["finish_reason"] != "stop":
            raise AssertionError(f"[{config}] stream {i}: {n} audio tokens "
                                 f"({req['finish_reason']}), fewer than "
                                 f"{MIN_WINDOWS[fam]} full windows")
        full.append(not short)
        upload = bool((REQUESTS.get(config) or [{}] * 4)[i].get("audio"))
        log(f"[{config}] stream {i} ({st['rid8']}, "
            f"{'upload' if upload else 'text'}): {n} audio tokens after a "
            f"{req['prompt_tokens']}-token prompt ({req['finish_reason']}"
            f"{', sampled the stop id early' if short else ''}) -> "
            f"{st['samples']} samples = {st['samples'] / window:.2f} windows"
            f" at 24,000 Hz (overlap rule: {want}; windows "
            f"{req['detok_windows']}); TTFA {st['ttfa_s'] * 1e3:.1f} ms, "
            f"{st['samples'] / window / st['wall_s']:.3f} windows/s")
    if fam in RUN_MIN_WINDOWS:
        longest = max(len(done[st["rid8"]]["detok_windows"])
                      for st in out["streams"])
        if longest < RUN_MIN_WINDOWS[fam]:
            raise AssertionError(f"[{config}] no stream decoded "
                                 f"{RUN_MIN_WINDOWS[fam]} windows")
    elif not any(full):
        raise AssertionError(f"[{config}] no stream reached "
                             f"{MIN_WINDOWS[fam]} windows")
    failed = [line for line in (OUT / f"chip_smoke_server_{config}.log")
              .read_text().splitlines() if "extraction failed" in line
              or "encoder load failed" in line]
    if failed:
        raise AssertionError(f"[{config}] uploads fell back: {failed[:2]}")
    steps = stats["steps"]
    probe = steps["probe_ms"]
    dec = {k: v for k, v in probe.items() if k.startswith("decode ")}
    det = {k: v for k, v in probe.items() if k.startswith("detok ")}
    pre = {k: v for k, v in probe.items() if k.startswith("prefill ")}
    ph = stats["phase_stats"]
    det_t, det_n = ph.get("detokenize", (0.0, 0))
    pp_t, pp_n = ph.get("preprocess", (0.0, 0))
    cap, mib = steps["capture_s_by_kind"], steps["pool_mib_by_kind"]
    log(f"[{config}] {name} (watermark {stats['watermark']}): TTFA "
        f"median {out['ttfa_median_s'] * 1e3:.1f} ms; "
        f"{out['frames_per_s']:.3f} windows/s aggregate over "
        f"{len(out['streams'])} streams (real time: "
        f"{SAMPLE_RATE / window:.3f} per stream); decode replay ms (probe) "
        f"{dec}; prefill replay ms (probe) {pre}; detokenize replay ms "
        f"(probe) {det}; detokenize wall {det_t / max(det_n, 1) * 1e3:.2f} "
        f"ms per call; preprocess wall {pp_t / max(pp_n, 1) * 1e3:.1f} ms x "
        f"{pp_n}; detokenize graphs ({holds}): "
        f"{sum(1 for g in steps['graphs'] if g[0] == 'detok')} captured in "
        f"{cap.get('detok', 0.0):.2f} s, pool +{mib.get('detok', 0.0):.1f} "
        f"MiB; capture s by kind {cap}; init memory {stats['init_memory_gb']}"
        " GB")


def check_profile_run(config: str, stats: dict, out: dict) -> None:
    """Run Z: the full-batch decode graphs replayed, and its start-up."""
    served = CONFIGS[config][2]
    top = served["max_batch_size"]
    steps = stats["steps"]
    full = {k: c["replays"] for k, c in steps["captured"].items()
            if k.startswith(f"decode {top} ") and c["replays"]}
    if not full:
        raise AssertionError(f"[{config}] no decode graph at the top bucket "
                             f"B={top} was replayed: {steps['replays']}")
    mem = stats["memory_gb"]
    log(f"[{config}] the profile served: batch {top}, "
        f"{stats['num_pages']} pages of {stats['page_size']} tokens, decode "
        f"buckets {stats['decode_buckets']}, prefill buckets "
        f"{stats['prefill_token_buckets']}, codec {stats['codec_dtypes']}, "
        f"pipeline depth {stats['pipeline_depth']}; ready in "
        f"{out['ready_s']:.1f} s, {len(steps['graphs'])} graphs captured in "
        f"{steps['capture_s']:.2f} s; init memory {stats['init_memory_gb']}"
        f" GB; after start-up {mem}; {len(out['streams'])} streams: "
        f"{out['frames_per_s']:.1f} frames/s aggregate "
        f"({out['frames_per_s'] / len(out['streams']):.2f} a stream, real "
        f"time 12.50), TTFA median {out['ttfa_median_s'] * 1e3:.1f} ms; "
        f"full-batch decode replays {full}")


def check_split_run(config: str, stats: dict) -> None:
    """Run DG: every detokenize graph on cuda:1 and every LM graph on
    cuda:0; K2 only in detokenize graphs, K1 and K3 only in LM graphs."""
    steps = stats["steps"]
    by_dev = steps["graphs_by_device"]
    lm = {" ".join(map(str, g)) for g in by_dev.get("cuda:0", [])}
    detok = {" ".join(map(str, g)) for g in by_dev.get("cuda:1", [])}
    if not detok or any(not k.startswith("detok ") for k in detok) or any(
            k.startswith("detok ") for k in lm):
        raise AssertionError(f"[{config}] graphs by device {by_dev}")
    for key, c in steps["captured"].items():
        for name, where in ((K2, detok), (K1, lm), (K3, lm)):
            if c.get(f"{name}.launches", 0) and key not in where:
                raise AssertionError(f"[{config}] {name} launched by graph "
                                     f"{key} outside its card's graphs")
    log(f"[{config}] LM graphs on cuda:0 ({len(lm)}), detokenize graphs on "
        f"cuda:1 ({len(detok)}); pool MiB by card "
        f"{steps['pool_mib_by_device']}; memory {stats['memory_gb']}; K1 "
        f"{stats['launches'][K1]}, K3 {stats['launches'][K3]} on cuda:0, "
        f"{K2} {stats['resunit_stacks']} stacks on cuda:1")


def check_dp_run(config: str, rank1: Path, stats: dict) -> list:
    """Run DP: rank 1's daemon served streams too (round robin), with K1,
    K3 and K6 only; returns its completed requests."""
    for _ in range(100):
        if rank1.exists() and rank1.stat().st_size:
            break
        time.sleep(0.1)
    st1 = json.loads(rank1.read_text())
    served = {0: len(stats["requests"]), 1: len(st1["requests"])}
    if st1["rank"] != 1 or min(served.values()) < 1:
        raise AssertionError(f"[{config}] streams served per rank {served}")
    for name, n in st1["launches"].items():
        if (n > 0) != (name in {K1, K3} | depth_kernels(config)):
            raise AssertionError(f"[{config}] rank 1 launched {name} {n} "
                                 "times")
    log(f"[{config}] streams served per rank {served}; rank 1 launches "
        f"{st1['launches']}")
    return st1["requests"]


def refused(flags: list, count: int) -> float:
    """The launcher asked for more cards than the machine has must exit
    non-zero within 60 s, name the count and leave no daemon behind;
    returns its seconds."""
    port = free_port()
    cmd = [sys.executable, "-m", "vox_serve_tpu_torch.launch", "--model",
           "qwen3-tts", "--host", "127.0.0.1", "--port", str(port),
           "--socket-suffix", f"_refuse{port}", *flags]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        raise AssertionError(f"{' '.join(flags)}: not refused within 60 s")
    dt = time.perf_counter() - t0
    try:
        os.killpg(proc.pid, 0)
        alive = True
    except ProcessLookupError:
        alive = False
    if alive:
        os.killpg(proc.pid, signal.SIGKILL)
    want = f"this machine has {count}"
    if proc.returncode == 0 or want not in text or alive:
        raise AssertionError(
            f"{' '.join(flags)}: exit {proc.returncode}, a daemon left "
            f"{alive}, message {want!r} "
            f"{'found' if want in text else 'missing'}; output tail:\n"
            + "\n".join(text.splitlines()[-20:]))
    line = next(x for x in text.splitlines() if want in x)
    log(f"refused {' '.join(flags)} in {dt:.1f} s with exit "
        f"{proc.returncode}: {line.strip()!r}; no daemon left")
    return dt


def two_card_phase(card: str) -> dict:
    """DG and DP where the machine has two cards; else the refusals of
    ``--enable-disaggregation`` and ``--dp-size 2``."""
    import torch

    n = torch.cuda.device_count()
    if n >= 2:
        log(f"{n} CUDA cards: runs DG and DP")
        return {c: end_to_end(card, c) for c in ("DG", "DP")}
    refused(["--enable-disaggregation"], n)
    refused(["--dp-size", "2"], n)
    log(f"two-card runs DG (--enable-disaggregation) and DP (--dp-size 2) "
        f"not run: this machine has {n} CUDA card; both were refused at "
        "start-up instead")
    return {}


def check_tp_run(config: str, stats: dict, out: dict) -> None:
    """Runs TP and TPG: every rank served every LM step as a graph replay
    (no eager call), launched K1 and K3 (and K5 in TPG) once a layer per
    step as rank 0 did, and nothing else, and holds its KV heads only:
    the pool's bytes / tp; ``out["launches"]`` becomes the sum over the
    ranks. Prints each rank's decode probes and the all-reduce's ms per
    call at decode and prefill rows."""
    from vox_serve_tpu_torch.parallel.sharding import tp_heads

    fam = family(config)
    layers = LAYERS[fam]
    _, H, KH, D, _, _ = K5_WIDTHS[fam]
    ranks = stats["tp_ranks"]
    if stats["tp_size"] != TP_SIZE or [r.get("rank") for r in ranks] != \
            list(range(TP_SIZE)):
        raise AssertionError(f"[{config}] tp_size {stats['tp_size']}, "
                             f"ranks {ranks}")
    steps = stats["steps"]
    n_steps, replays = steps["decode_steps"], steps["replays"]
    prefills = replays.get("prefill", 0) + replays.get("cold_chain", 0)
    lm = {k: n for k, n in replays.items() if k != "detok"}
    want = {K1: layers * n_steps, K3: layers * prefills}
    if K5 in CONFIGS[config][3]:
        want[K5] = K5_PER_LAYER * layers * (prefills + n_steps)
    kv_bytes = (layers * 2048 * 16 * 2 * tp_heads(H, KH, TP_SIZE)[1] * D
                * 2)
    total = dict(stats["launches"])
    for r in ranks:
        if any(r["eager_calls"].values()):
            raise AssertionError(f"[{config}] rank {r['rank']} ran steps "
                                 f"eagerly: {r['eager_calls']}")
        if r["kv_pool_bytes"] != kv_bytes:
            raise AssertionError(f"[{config}] rank {r['rank']}'s pool: "
                                 f"{r['kv_pool_bytes']} bytes, expected "
                                 f"{kv_bytes}")
        if r["rank"] == 0:
            continue
        if r["replays"] != lm or r["graphs"] != [
                g for g in ranks[0]["graphs"] if g[0] != "detok"]:
            raise AssertionError(f"[{config}] rank {r['rank']} replays "
                                 f"{r['replays']} / graphs {r['graphs']}, "
                                 f"rank 0's LM steps {lm}")
        got = {k: n for k, n in r["launches"].items() if n}
        if got != want:
            raise AssertionError(f"[{config}] rank {r['rank']} launched "
                                 f"{got}, expected {want}")
        for k, n in got.items():
            total[k] += n
    out["launches"] = total
    out["allreduce_ms"] = stats["allreduce_ms"]
    for r in ranks:
        probes = {k: round(v, 3) for k, v in r["probe_ms"].items()
                  if k.startswith("decode ")}
        log(f"[{config}] rank {r['rank']} ({r['device']}): "
            f"{len(r['graphs'])} graphs, pool {r.get('pool_mib', 0):.1f} "
            f"MiB, KV pool {r['kv_pool_bytes'] / 2**20:.1f} MiB "
            f"{r['kv_pool_shape']}, replays {r['replays']}, eager calls 0; "
            f"decode probes (ms per replay) {probes}"
            + (f"; pack message to the ranks "
               f"{r['mirror_run_ms']:.4f} ms per step" if "mirror_run_ms"
               in r else ""))
    log(f"[{config}] all-reduce device ms per call by rows (hidden "
        f"{K5_WIDTHS[fam][0]}, bf16, in a graph): {stats['allreduce_ms']}; "
        f"launches summed over the {TP_SIZE} ranks {total}")


def four_card_phase(card: str, runs: dict) -> dict:
    """TP and TPG where the machine has four cards, each compared with the
    one-card run of the same model served in this call (A, Q); else the
    refusal of ``--tp-size 4``."""
    import torch

    n = torch.cuda.device_count()
    if n < TP_SIZE:
        refused(["--tp-size", str(TP_SIZE)], n)
        log(f"four-card runs TP and TPG (--tp-size {TP_SIZE}) not run: "
            f"this machine has {n} CUDA card(s); the launcher refused "
            f"--tp-size {TP_SIZE} at start-up instead")
        return {}
    log(f"{n} CUDA cards: runs TP and TPG")
    out = {}
    for config, base in TP_RUNS.items():
        out[config] = r = end_to_end(card, config)
        one = runs[base]
        dec = sorted(k for k in r["probe_ms"] if k.startswith("decode 4 "))
        log(f"[{config}] vs {base}: {r['frames_per_s']:.3f} / "
            f"{one['frames_per_s']:.3f} units/s, TTFA median "
            f"{r['ttfa_median_s'] * 1e3:.1f} / {one['ttfa_median_s'] * 1e3:.1f}"
            f" ms, decode step wall {r['decode_step_ms']:.2f} / "
            f"{one['decode_step_ms']:.2f} ms, decode probe at B=4 "
            + ", ".join(f"{k}: {r['probe_ms'][k]:.3f} / "
                        f"{one['probe_ms'].get(k, float('nan')):.3f}"
                        for k in dec) + " ms")
    return out


def check_run(config: str, card: str, stats: dict, out: dict) -> None:
    """Print a served run's numbers and hold its stats file to what the
    configuration must have run (see the module docstring)."""
    _flags, _env, served, must_run = CONFIGS[config]
    must_run = must_run | depth_kernels(config)
    model, fam = MODEL_OF.get(config, "qwen3-tts"), family(config)
    layers = LAYERS[fam]
    ph = stats["phase_stats"]
    steps = stats["steps"]
    n_steps = steps["decode_steps"]
    replays = steps["replays"]
    captured = steps["captured"]
    launches = stats["launches"]

    def per_call(kind):
        t = sum(ph.get(f"{kind}.{p}", (0.0, 0))[0]
                for p in ("plan", "dispatch", "resolve"))
        return t, ph.get(f"{kind}.dispatch", (0.0, 0))[1]

    t1, n1 = per_call("decode")
    tk, nk = per_call("decode_multi")
    det_t, det_n = ph.get("detokenize", (0.0, 0))
    pre_t, pre_n = ph.get("prefill", (0.0, 0))
    pp_t, pp_n = ph.get("preprocess", (0.0, 0))
    wins, batches = ph.get("detok.windows", (0.0, 0))
    ttfa = out["ttfa"]
    out["decode_step_ms"] = (t1 + tk) / max(n_steps, 1) * 1e3
    out["init_memory_gb"] = stats["init_memory_gb"]
    solo = (f"; solo stream TTFA {out['solo_ttfa_s'] * 1e3:.1f} ms"
            if "solo_ttfa_s" in out else "")
    unit = MODELS[fam]["unit"]
    log(f"[{config}] e2e on {card}: {model}, {len(ttfa)} "
        f"streams, {out['frames']:.1f} {unit} in {out['wall']:.2f} s = "
        f"{out['frames_per_s']:.1f} {unit}/s "
        f"aggregate; TTFA min/median/max {ttfa[0] * 1e3:.1f}/"
        f"{out['ttfa_median_s'] * 1e3:.1f}/{ttfa[-1] * 1e3:.1f} ms{solo}; "
        f"decode step wall (plan + dispatch + resolve) "
        f"{(t1 + tk) / max(n_steps, 1) * 1e3:.2f} ms over {n_steps} steps "
        f"(single {t1 / max(n1, 1) * 1e3:.2f} ms x {n1} calls, fused "
        f"{tk / max(nk, 1) * 1e3:.2f} ms x {nk} calls); detokenize wall "
        f"{det_t / max(det_n, 1) * 1e3:.2f} ms per call over {det_n} calls "
        f"({batches} batches of {wins / max(batches, 1):.2f} windows); "
        f"prefill wall {pre_t / max(pre_n, 1) * 1e3:.2f} ms x {pre_n}; "
        f"preprocess {pp_t / max(pp_n, 1) * 1e3:.2f} ms x {pp_n}; "
        f"cold starts {steps['cold_starts']}; params LM "
        f"{stats['param_count']['lm'] / 1e9:.3f} B + codec "
        f"{stats['param_count']['codec'] / 1e6:.1f} M")
    log(f"[{config}] graphs: {len(steps['graphs'])} captured in "
        f"{steps['capture_s']:.2f} s, pool {steps['pool_mib']:.1f} MiB; "
        f"replays {replays}; eager calls {steps['eager_calls']}; deepest "
        f"pipelines: decode {steps['max_pending']}, detokenize "
        f"{steps['max_pending_detok']}; polled {steps['polled']}; device "
        f"ms per replay (start-up probe): "
        + ", ".join(f"{k}={v:.3f}" for k, v in steps["probe_ms"].items()))
    log(f"[{config}] served {stats['model']} "
        f"{({k: stats[k] for k in served})}; kernel "
        f"launches {launches}; resunit stacks {stats['resunit_stacks']} "
        f"(bf16 {stats['resunit_bf16_stacks']}); replay order "
        f"{steps['replay_spans']}")
    if "text_stream_ttfa" in out:
        log(f"[{config}] TTFA of the text streams (first piece to first PCM "
            "byte) " + ", ".join(f"{t * 1e3:.1f}" for t in
                                 out["text_stream_ttfa"])
            + " ms; of the /generate streams " + ", ".join(
                f"{t * 1e3:.1f}" for t in out["generate_ttfa"]) + " ms")
    if stats["model"] != model:
        raise AssertionError(f"[{config}] the daemon served {stats['model']}"
                             f", expected {model}")
    for key, want in {"weight_quant": "none", **served}.items():
        if stats[key] != want:
            raise AssertionError(f"[{config}] served {key}={stats[key]!r}, "
                                 f"expected {want!r}")
    if stats["backbone_bytes"] <= 0:
        raise AssertionError(f"[{config}] backbone bytes "
                             f"{stats['backbone_bytes']}")
    for name, n in launches.items():
        if name in must_run and n <= 0:
            raise AssertionError(f"[{config}] kernel {name} never launched "
                                 "on the main path")
        if name not in must_run and n != 0:
            raise AssertionError(f"[{config}] kernel {name} launched {n} "
                                 "times; this configuration must not run it")
    # every step was a graph replay: no step body ran eagerly, and every
    # kind the run needs was replayed
    if any(steps["eager_calls"].values()):
        raise AssertionError(f"[{config}] step bodies ran eagerly on the "
                             f"card: {steps['eager_calls']}")
    for kind in ("prefill", "detok"):
        if not replays.get(kind):
            raise AssertionError(f"[{config}] no {kind} graph was replayed")
    if not (replays.get("decode") or replays.get("decode_multi")):
        raise AssertionError(f"[{config}] no decode graph was replayed")
    # each replay counted the kernels its capture launched: K3 once per
    # talker layer and prefill, the decode kernel once per layer and step
    prefills = replays.get("prefill", 0) + replays.get("cold_chain", 0)
    if launches[K3] != layers * prefills:
        raise AssertionError(
            f"[{config}] {K3} launched {launches[K3]} times, expected "
            f"{layers} x {prefills} prefill and cold-chain replays")
    (decode_kernel,) = must_run & {K1, K1Q, K4}
    if launches[decode_kernel] != layers * n_steps:
        raise AssertionError(
            f"[{config}] {decode_kernel} launched {launches[decode_kernel]}"
            f" times, expected {layers} x {n_steps} decode steps")
    log(f"[{config}] {K3}: {launches[K3]} launches = {layers} layers x "
        f"{prefills} prefill replays; {decode_kernel}: "
        f"{launches[decode_kernel]} launches = {layers} layers x {n_steps} "
        "decode steps")
    if K5 in must_run:
        want_k5 = K5_PER_LAYER * layers * (prefills + n_steps)
        if launches[K5] != want_k5:
            raise AssertionError(
                f"[{config}] {K5} launched {launches[K5]} times, expected "
                f"{K5_PER_LAYER} x {layers} x ({prefills} prefill + "
                f"{n_steps} decode steps)")
        # and each prefill and decode graph launches it 4 times a layer
        for key, cg in captured.items():
            got = cg.get(f"{K5}.launches", 0)
            if key.split()[0] in ("prefill", "decode") \
                    and got != K5_PER_LAYER * layers:
                raise AssertionError(
                    f"[{config}] graph {key} launches {K5} {got} times a "
                    f"replay, expected {K5_PER_LAYER} x {layers} layers")
        log(f"[{config}] {K5}: {launches[K5]} launches = {K5_PER_LAYER} "
            f"launches (q/k/v, o, gate/up, down) x {layers} layers x "
            f"({prefills} prefill replays + {n_steps} decode steps), "
            f"{K5_PER_LAYER} x {layers} in every prefill and decode graph, "
            f"none eager; backbone {stats['backbone_bytes'] / 1e9:.3f} GB")
    # and every counter is the sum over graphs of replays x captured counts
    want = {name: 0 for name in launches}
    stacks = {K2: 0, K2H: 0}
    for c in captured.values():
        for name in want:
            want[name] += c["replays"] * c.get(f"{name}.launches", 0)
        for name in stacks:
            stacks[name] += c["replays"] * c.get(f"{name}.stacks", 0)
    got_stacks = {K2: stats["resunit_stacks"],
                  K2H: stats["resunit_bf16_stacks"]}
    if want != launches or stacks != got_stacks:
        raise AssertionError(
            f"[{config}] launches {launches} / stacks {got_stacks} differ "
            f"from the graphs' replays x captured counts {want} / {stacks}")
    k2 = K2H if served["codec_dtypes"] == ["bfloat16"] else K2
    if served["fused_resunit"] and stacks[k2] <= 0:
        raise AssertionError(f"[{config}] no {k2} stack ran in a graph")
    if served["scheduler_type"] == "offline":
        spans = steps["replay_spans"]
        last_lm = max(spans[k][1] for k in LM_KINDS if k in spans)
        if spans["detok"][0] <= last_lm:
            raise AssertionError(
                f"[{config}] a detokenize replay ({spans['detok']}) was "
                f"issued before the last LM step ({last_lm})")
    if served["fused_decode_steps"]:
        if not replays.get("decode_multi"):
            raise AssertionError(f"[{config}] no fused decode graph ran")
        if steps["max_pending"] < served["pipeline_depth"]:
            raise AssertionError(f"[{config}] the readback pipeline never "
                                 f"held {served['pipeline_depth']} steps")
    if served["first_chunk_frames"]:
        chained = replays.get("cold_chain", 0) + replays.get(
            "decode_multi_detok", 0)
        if fam == "csm" and chained:
            raise AssertionError(f"[{config}] CSM's rows chained: {replays}")
        if fam != "csm" and not replays.get("cold_chain"):
            raise AssertionError(f"[{config}] no cold chain was replayed")
        minis = {int(k.split()[2]) for k, c in captured.items()
                 if k.startswith("detok ") and c["replays"]}
        F = served["first_chunk_frames"]
        if not {F, 2 * F} <= minis:
            raise AssertionError(f"[{config}] detokenize lengths replayed "
                                 f"{sorted(minis)}, expected {F} and {2 * F}"
                                 " among them")
        if steps["max_pending_detok"] < served["detok_pipeline_depth"]:
            raise AssertionError(
                f"[{config}] the detokenize pipeline never held "
                f"{served['detok_pipeline_depth']} batches")


# ---------------------------------------------------------------------------
# phase 6: checkpoints in the published layouts, and runs L, M, N
# ---------------------------------------------------------------------------


def _rss_gb(key: str) -> float:
    """A size from /proc/self/status (VmRSS: the resident set), GB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


class RssPeak:
    """The peak resident set of this process while the block runs, GB:
    VmRSS sampled every 2 ms by a thread (the kernel's VmHWM is not
    offered everywhere, and cannot be reset everywhere)."""

    def __enter__(self):
        self.peak = _rss_gb("VmRSS")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, _rss_gb("VmRSS"))

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_gb("VmRSS"))


def _bits(t):
    import torch

    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def assert_bit_equal(label: str, written: dict, loaded: dict) -> int:
    """Every tensor the loader gave back (re-exported to the published
    names) has the dtype, shape and bits of the one written."""
    import torch

    if set(written) != set(loaded):
        raise AssertionError(f"[load] {label}: names differ: "
                             f"{sorted(set(written) ^ set(loaded))[:8]}")
    for k, w in written.items():
        r = loaded[k]
        if (r.dtype != w.dtype or tuple(r.shape) != tuple(w.shape)
                or not torch.equal(_bits(r).to(w.device), _bits(w))):
            raise AssertionError(f"[load] {label}: {k} differs from the "
                                 f"tensor written ({r.dtype} {tuple(r.shape)}"
                                 f" vs {w.dtype} {tuple(w.shape)})")
    return len(written)


def timed_load(label: str, files: list, load, written: dict,
               reexport, write_s: float) -> dict:
    """Resolve and load one snapshot onto the card (``load``), timed, with
    the peak resident set of this process over the load; then hold every
    tensor bit-equal to the written ones (``reexport`` maps the loaded
    tree back to the published names)."""
    import gc

    gc.collect()
    _sync()
    base = _rss_gb("VmRSS")
    with RssPeak() as rss:
        t0 = time.perf_counter()
        loaded = load()
        _sync()
        dt = time.perf_counter() - t0
    peak = rss.peak
    if loaded is None:
        raise AssertionError(f"[load] {label}: the loader fell back to "
                             "random init")
    n = assert_bit_equal(label, written, reexport(loaded))
    nbytes = sum(os.path.getsize(f) for f in files)
    params = sum(t.numel() for k, t in written.items()
                 if not k.endswith("num_batches_tracked"))
    r = {"gb": nbytes / 1e9, "s": dt, "gb_per_s": nbytes / 1e9 / dt,
         "peak_rss_gb": peak, "rss_before_gb": base, "write_s": write_s,
         "params": params, "tensors": n}
    log(f"[load] {label}: {r['gb']:.3f} GB in {len(files)} file(s), "
        f"{params / 1e9:.4f} B params (written in {write_s:.1f} s); "
        f"resolved through the hub cache and loaded onto the card in "
        f"{dt:.2f} s = {r['gb_per_s']:.2f} GB/s; peak RSS {peak:.2f} GB "
        f"(before {base:.2f} GB, sampled every 2 ms); {n} tensors "
        "bit-equal to those written")
    return r


def _free() -> None:
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _files(snap) -> list:
    return sorted(str(p) for p in Path(snap).rglob("*") if p.is_file())


def _drop_snapshot(cache: Path, model_id: str) -> None:
    import shutil

    shutil.rmtree(cache / ("models--" + model_id.replace("/", "--")),
                  ignore_errors=True)


def cosy_files(lm, text, flow, hift, s3, camp) -> dict:
    """Every tensor of a CosyVoice2 snapshot by ``file:name`` (the
    exporters of ``synthetic_checkpoints.py``)."""
    import synthetic_checkpoints as synth

    files = {"model.safetensors": synth.export_cosy_lm(lm, text),
             "flow.pt": synth.export_cosy_flow(flow),
             "hift.pt": synth.export_hift(hift),
             "speech_tokenizer_v2.onnx": synth.export_s3v2(s3),
             "campplus.onnx": synth.export_campplus(camp)}
    return {f"{f}:{k}": v for f, sd in files.items() for k, v in sd.items()}


def cosy_checkpoint(card: str, cache: Path, dev) -> tuple[dict, dict]:
    """Write the FunAudioLLM/CosyVoice2-0.5B snapshot at the published
    widths (the 24 x 896 Qwen2 LM in bf16 with its 151,936-row text table,
    the default flow and HiFT in float32, the full S3 v2 and CAMPPlus as
    ONNX), load it on the card through the model's constructor, hold every
    tensor bit-equal to the one written, and serve run P from it."""
    import torch

    import synthetic_checkpoints as synth
    from vox_serve_tpu_torch.codecs.cosyvoice_flow import (CosyFlowConfig,
                                                           init_cosy_flow)
    from vox_serve_tpu_torch.codecs.hifigan import HiFTConfig, init_hift
    from vox_serve_tpu_torch.encoders.campplus import load_campplus_params
    from vox_serve_tpu_torch.encoders.s3_exact import (S3V2Config,
                                                       init_s3v2_params)
    from vox_serve_tpu_torch.models.backbone import seeded_generator
    from vox_serve_tpu_torch.models.cosyvoice2 import CosyVoice2LM

    src = CosyVoice2LM(COSY_ID, device=dev, seed=51)
    g = seeded_generator(dev, 52)
    flow = init_cosy_flow(CosyFlowConfig(), g, dev)
    hift = init_hift(HiFTConfig(), g, dev)
    s3 = init_s3v2_params(g, S3V2Config(), dev)
    camp_sd = synth.campplus_state(torch.Generator().manual_seed(53))
    camp = load_campplus_params(camp_sd, device=dev)
    snap = synth.snapshot_dir(cache, COSY_ID)
    t0 = time.perf_counter()
    synth.write_cosyvoice2(snap, src.params, src.text_embed, flow, hift, s3,
                           camp_sd)
    ws = time.perf_counter() - t0
    written = cosy_files(src.params, src.text_embed, flow, hift, s3, camp)
    del src, flow, hift, s3, camp, camp_sd
    _free()

    def load():
        m = CosyVoice2LM(COSY_ID, device=dev)
        if not all(m.checkpoint_parts.values()):
            raise AssertionError(f"[load] {COSY_ID}: parts from random init:"
                                 f" {m.checkpoint_parts}")
        return m

    load_r = timed_load(
        COSY_ID, _files(snap), load, written,
        lambda m: cosy_files(m.params, m.text_embed, m.codec_params["flow"],
                             m.codec_params["hift"], m.s3v2[0], m.campplus),
        ws)
    del written
    _free()
    return load_r, end_to_end(card, "P", hub=str(cache))


def glm_decoder_files(flow, hift) -> dict:
    """Every tensor of the zai-org/glm-4-voice-decoder snapshot by
    ``file:name``."""
    import synthetic_checkpoints as synth

    files = {"flow.pt": synth.export_glm_flow(flow),
             "hift.pt": synth.export_hift(hift)}
    return {f"{f}:{k}": v for f, sd in files.items() for k, v in sd.items()}


def glm_checkpoint(card: str, cache: Path, dev) -> tuple[dict, dict]:
    """Write GLM-4-Voice's three repos at the published widths and names:
    zai-org/glm-4-voice-9b in the ChatGLM layout (fused q/k/v with random
    biases and fused gate/up, bf16) at 4 of its 40 layers, then
    zai-org/glm-4-voice-decoder (``flow.pt``, ``hift.pt`` under
    ``generator.``) and zai-org/glm-4-voice-tokenizer (the Whisper-VQ
    encoder's safetensors); load each on the card through the model's
    loaders, every tensor bit-equal to the one written; drop the LM
    snapshot and serve run R from the other two."""
    import torch

    import synthetic_checkpoints as synth
    from vox_serve_tpu_torch.codecs.glm_flow import init_glm_flow
    from vox_serve_tpu_torch.codecs.hifigan import init_hift
    from vox_serve_tpu_torch.encoders.whisper_exact import init_glm_vq_params
    from vox_serve_tpu_torch.models.backbone import (BackboneConfig,
                                                     seeded_generator)
    from vox_serve_tpu_torch.models.glm_voice import GLMVoiceLM
    from vox_serve_tpu_torch.weights import save_safetensors

    loads = {}
    cfg4 = BackboneConfig(
        vocab_size=168960, hidden_size=4096, num_layers=4, num_heads=32,
        num_kv_heads=2, head_dim=128, intermediate_size=13696,
        qkv_bias=True, rope_dim=64, rope_interleaved=True,
        rms_eps=1.5625e-07)
    src = GLMVoiceLM(GLM_ID, device=dev, seed=61, debug_backbone=cfg4)
    g = seeded_generator(dev, 62)
    for n in ("q", "k", "v"):
        src.params["backbone"]["layers"]["attn"][n]["b"].normal_(generator=g)
    state = synth.export_glm(src.params)
    snap = synth.snapshot_dir(cache, GLM_ID)
    t0 = time.perf_counter()
    synth.write_shards(snap, state, 2)
    loads[GLM_ID + " (4 of 40 layers)"] = timed_load(
        GLM_ID, _files(snap), src._load_lm, state, synth.export_glm,
        time.perf_counter() - t0)
    _drop_snapshot(cache, GLM_ID)
    del state

    flow = init_glm_flow(src.flow_config, g, dev)
    hift = init_hift(src.hift_config, g, dev)
    dsnap = synth.snapshot_dir(cache, GLM_DECODER)
    t0 = time.perf_counter()
    synth.write_glm_decoder(dsnap, flow, hift)
    ws = time.perf_counter() - t0

    def load_decoder():
        f, h = src._load_decoder()
        return None if f is None or h is None else (f, h)

    loads[GLM_DECODER] = timed_load(
        GLM_DECODER, _files(dsnap), load_decoder,
        glm_decoder_files(flow, hift), lambda fh: glm_decoder_files(*fh), ws)

    vq = init_glm_vq_params(seeded_generator(dev, 63), src.vq_config, dev)
    vstate = synth.export_glm_vq(vq)
    tsnap = synth.snapshot_dir(cache, GLM_TOKENIZER)
    t0 = time.perf_counter()
    save_safetensors(vstate, tsnap / "model.safetensors")
    ws = time.perf_counter() - t0

    def load_vq():
        p = src._load_vq()
        return p if src.checkpoint_parts["vq_encoder"] else None

    loads[GLM_TOKENIZER] = timed_load(GLM_TOKENIZER, _files(tsnap), load_vq,
                                      vstate, synth.export_glm_vq, ws)
    GLM_VQ_PARAMS["R"] = vq
    del src, flow, hift, vstate
    _free()
    try:
        run = end_to_end(card, "R", hub=str(cache))
    finally:
        GLM_VQ_PARAMS.pop("R", None)
        _free()
    return loads, run


def step_token2wav_files(flow, hift) -> dict:
    """Every tensor of the stepfun-ai/Step-Audio-2-mini snapshot's
    ``token2wav/`` files by ``file:name``."""
    import synthetic_checkpoints as synth

    files = {"token2wav/flow.pt": synth.export_step_flow(flow),
             "token2wav/hift.pt": synth.export_hift(hift)}
    return {f"{f}:{k}": v for f, sd in files.items() for k, v in sd.items()}


def step_checkpoint(card: str, cache: Path, dev) -> tuple[dict, dict]:
    """Write stepfun-ai/Step-Audio-2-mini in the published layout: the
    Qwen2.5 LM at full width but 4 of its 28 layers (q/k/v with random
    biases, ``lm_head``, bf16) with the full 32-layer audio encoder and the
    adaptor (``encoder.*``, ``adapter.*``, bf16) in two safetensors
    shards, and ``token2wav/flow.pt`` and ``token2wav/hift.pt`` (under
    ``generator.``); load each through the model's loaders onto the card,
    every tensor bit-equal to the one written; then serve run T from that
    snapshot (its LM does not map at 28 layers, so the backbone and the
    encoder are random, as in JAX; the flow and HiFT load)."""
    import torch

    import synthetic_checkpoints as synth
    from vox_serve_tpu_torch.codecs.hifigan import load_hift_params
    from vox_serve_tpu_torch.codecs.step_dit import load_step_flow_params
    from vox_serve_tpu_torch.models.backbone import (BackboneConfig,
                                                     seeded_generator)
    from vox_serve_tpu_torch.models.step_audio_2 import StepAudio2LM
    from vox_serve_tpu_torch.weights import resolve_model_dir

    loads = {}
    cfg4 = BackboneConfig(
        vocab_size=158720, hidden_size=3584, num_layers=4, num_heads=28,
        num_kv_heads=4, intermediate_size=18944, qkv_bias=True,
        rope_theta=1_000_000.0)
    src = StepAudio2LM(STEP_ID, device=dev, seed=71, debug_backbone=cfg4)
    g = seeded_generator(dev, 72)
    for n in ("q", "k", "v"):
        src.params["backbone"]["layers"]["attn"][n]["b"].normal_(generator=g)
    state = synth.export_step(src.params, src.enc_params, torch.bfloat16)
    snap = synth.snapshot_dir(cache, STEP_ID)
    t0 = time.perf_counter()
    synth.write_shards(snap, state, 2)
    ws = time.perf_counter() - t0
    lm_files = _files(snap)

    def load_lm():
        lm, enc = src._load_lm(resolve_model_dir(STEP_ID))
        return None if lm is None or enc is None else (lm, enc)

    loads[STEP_ID + " LM (4 of 28 layers) + audio encoder"] = timed_load(
        STEP_ID, lm_files, load_lm, state,
        lambda le: synth.export_step(le[0], le[1], torch.bfloat16), ws)
    del state

    flow, hift = src.codec_params["flow"], src.codec_params["hift"]
    t0 = time.perf_counter()
    synth.write_step_token2wav(snap, flow, hift)
    ws = time.perf_counter() - t0
    model_dir = resolve_model_dir(STEP_ID)

    def load_codec():
        f = src._load_part("flow", model_dir, "token2wav/flow.pt",
                           lambda sd: load_step_flow_params(
                               sd, src.flow_config, device=dev))
        h = src._load_part("hift", model_dir, "token2wav/hift.pt",
                           lambda sd: load_hift_params(
                               {k.replace("generator.", ""): v
                                for k, v in sd.items()}, src.hift_config,
                               device=dev))
        return None if f is None or h is None else (f, h)

    loads[STEP_ID + " token2wav"] = timed_load(
        STEP_ID + " token2wav", [f for f in _files(snap)
                                 if f not in lm_files], load_codec,
        step_token2wav_files(flow, hift),
        lambda fh: step_token2wav_files(*fh), ws)
    del src, flow, hift
    _free()
    try:
        run = end_to_end(card, "T", hub=str(cache))
    finally:
        _free()
    return loads, run


def chatterbox_files(lm, cond, flow, hift, s3, camp) -> dict:
    """Every tensor of a ResembleAI/chatterbox snapshot's safetensors files
    by ``file:name`` (the exporters of ``synthetic_checkpoints.py``)."""
    import synthetic_checkpoints as synth

    files = {"t3_cfg.safetensors": synth.export_chatterbox_t3(lm, cond),
             "s3gen.safetensors": synth.export_chatterbox_s3gen(
                 flow, hift, s3, camp)}
    return {f"{f}:{k}": v for f, sd in files.items() for k, v in sd.items()}


def conds_tensors(conds: dict) -> dict:
    """The tensors of a ``conds.pt`` dict by ``conds.pt:{t3|gen}.name``,
    the decoder's prompt trimmed to 128 tokens and 256 mel rows (what the
    model keeps), on the host."""
    import numpy as np
    import torch

    from vox_serve_tpu_torch.models.chatterbox import (CONDS_PROMPT_FRAMES,
                                                       CONDS_PROMPT_TOKENS)

    out = {}
    for part, d in conds.items():
        for k, v in d.items():
            if v is None:
                continue
            t = torch.as_tensor(np.asarray(v))
            if part == "gen" and k == "prompt_token":
                t = t[:, :CONDS_PROMPT_TOKENS]
            if part == "gen" and k == "prompt_feat":
                t = t[:, :CONDS_PROMPT_FRAMES]
            out[f"conds.pt:{part}.{k}"] = t.contiguous()
    return out


def chatterbox_checkpoint(card: str, cache: Path, dev) -> tuple[dict, dict]:
    """Write ResembleAI/chatterbox in the published layout at the published
    widths (``t3_cfg.safetensors``: the 30 x 1024 T3 in bf16 with its
    tables, head and ``cond_enc.*``; ``s3gen.safetensors``: the flow, HiFT
    under ``mel2wav.``, the full S3 v2 under ``tokenizer.`` and CAMPPlus
    under ``speaker_encoder.`` in float32; ``conds.pt``) and
    resemble-ai/perth (``perth_net_250000.pth.tar``); load the first
    through the model's constructor and the second through the
    watermarker's loader onto the card, every tensor bit-equal to the one
    written (``conds.pt``'s stay on the host); then serve run V from
    both."""
    import torch

    import synthetic_checkpoints as synth
    from vox_serve_tpu_torch.encoders.campplus import load_campplus_params
    from vox_serve_tpu_torch.encoders.chatterbox_cond import \
        init_chatterbox_cond_params
    from vox_serve_tpu_torch.encoders.s3_exact import (S3V2Config,
                                                       init_s3v2_params)
    from vox_serve_tpu_torch.models.backbone import seeded_generator
    from vox_serve_tpu_torch.models.chatterbox import ChatterboxLM
    from vox_serve_tpu_torch.watermark import perth, spectral

    loads = {}
    src = ChatterboxLM(CHATTERBOX_ID, device=dev, seed=81)
    g = seeded_generator(dev, 82)
    cond = init_chatterbox_cond_params(
        g, dev, channels=src.backbone_config.hidden_size)
    s3 = init_s3v2_params(g, S3V2Config(), dev)
    camp = load_campplus_params(synth.campplus_state(
        torch.Generator().manual_seed(83)), device=dev)
    conds = synth.chatterbox_conds(torch.Generator().manual_seed(84),
                                   mel_dim=src.flow_config.mel_dim,
                                   spk_dim=src.flow_config.spk_dim)
    flow, hift = src.codec_params["flow"], src.codec_params["hift"]
    snap = synth.snapshot_dir(cache, CHATTERBOX_ID)
    t0 = time.perf_counter()
    synth.write_chatterbox(snap, src.params, cond, flow, hift, s3, camp,
                           conds)
    ws = time.perf_counter() - t0
    written = {**chatterbox_files(src.params, cond, flow, hift, s3, camp),
               **conds_tensors(conds)}
    del src, cond, s3, camp, flow, hift
    _free()

    def load():
        m = ChatterboxLM(CHATTERBOX_ID, device=dev)
        if not all(m.checkpoint_parts.values()):
            raise AssertionError(f"[load] {CHATTERBOX_ID}: parts from random"
                                 f" init: {m.checkpoint_parts}")
        return m

    loads[CHATTERBOX_ID] = timed_load(
        CHATTERBOX_ID, _files(snap), load, written,
        lambda m: {**chatterbox_files(
            m.params, m.cond_enc, m.codec_params["flow"],
            m.codec_params["hift"], m.s3v2[0], m.campplus),
            **conds_tensors(m.default_conds)}, ws)
    del written
    _free()

    pcfg = perth.PerthConfig()
    pp = perth.init_perth_params(pcfg, seeded_generator(dev, 85), dev)
    psnap = synth.snapshot_dir(cache, PERTH_ID)
    t0 = time.perf_counter()
    synth.write_perth(psnap, pp)
    ws = time.perf_counter() - t0

    def load_perth():
        real = spectral._try_load_real_perth(
            spectral.WatermarkConfig(style="perth"), dev)
        if real is not None and real["_perth_cfg"] != pcfg:
            raise AssertionError(f"Perth config {real['_perth_cfg']}")
        return real

    loads[PERTH_ID] = timed_load(
        PERTH_ID, _files(psnap), load_perth, synth.export_perth(pp),
        lambda real: synth.export_perth(real["perth"]), ws)
    del pp
    _free()
    try:
        run = end_to_end(card, "V", hub=str(cache))
    finally:
        _free()
    return loads, run


def zonos_checkpoint(card: str, cache: Path, dev) -> tuple[dict, dict]:
    """Write the three Zonos snapshots in their published layouts at the
    published widths: Zyphra/Zonos-v0.1-transformer (``model.safetensors``:
    the 26 x 2048 LM in bf16, ``prefix_conditioner.*`` in float32;
    ``config.json`` with the conditioner list), descript/dac_44khz
    (``model.safetensors``, float32) and
    Zyphra/Zonos-v0.1-speaker-embedding (the ResNet293 base and LDA-128
    ``.pt`` files); load each onto the card through the model's loaders,
    every tensor bit-equal to the one written; then serve run X from
    them."""
    import synthetic_checkpoints as synth
    from vox_serve_tpu_torch.codecs.snac import init_snac_decoder
    from vox_serve_tpu_torch.encoders.zonos_speaker import \
        init_zonos_speaker_params
    from vox_serve_tpu_torch.models.backbone import seeded_generator
    from vox_serve_tpu_torch.models.zonos import (DAC_CONFIG, SPEAKER_FILES,
                                                  ZonosLM)
    from vox_serve_tpu_torch.models.zonos_conditioning import \
        DEFAULT_CONDITIONERS

    def lm_files(params, cond):
        return {f"model.safetensors:{k}": v
                for k, v in synth.export_zonos(params, cond).items()}

    def speaker_files(params):
        return {f"{f}:{k}": v for f, sd in zip(
            SPEAKER_FILES, synth.export_zonos_speaker(params))
            for k, v in sd.items()}

    loads = {}
    src = ZonosLM(ZONOS_ID, device=dev, seed=91)
    dac = init_snac_decoder(DAC_CONFIG, seeded_generator(dev, 92), dev)
    spk = init_zonos_speaker_params(seeded_generator(dev, 93), dev)
    cond = src._cond_params
    # (id, writer, the model's loader, the tensors written by file:name,
    # the loaded tree back to them); the LM's loader also reads the
    # conditioner into src._cond_params, which its re-export then takes
    parts = [
        (ZONOS_ID, lambda snap: synth.write_zonos(
            snap, src.params, cond, src._conditioners),
         src._load_checkpoint, lambda: lm_files(src.params, cond),
         lambda t: lm_files(t, src._cond_params)),
        (DAC_ID, lambda snap: synth.write_dac(snap, dac), src._load_dac,
         lambda: synth.export_dac(dac), synth.export_dac),
        (ZONOS_SPEAKER_ID, lambda snap: synth.write_zonos_speaker(snap, spk),
         src._load_speaker_encoder, lambda: speaker_files(spk),
         speaker_files),
    ]
    for model_id, write, load, written, reexport in parts:
        snap = synth.snapshot_dir(cache, model_id)
        t0 = time.perf_counter()
        write(snap)
        loads[model_id] = timed_load(model_id, _files(snap), load, written(),
                                     reexport, time.perf_counter() - t0)
        _free()
    if src._conditioners != DEFAULT_CONDITIONERS or src._cond_params is cond:
        raise AssertionError("the conditioner was not read back from the "
                             f"snapshot: {src._conditioners}")
    del src, dac, spk, cond, parts
    _free()
    try:
        run = end_to_end(card, "X", hub=str(cache))
    finally:
        _free()
    return loads, run


def checkpoint_phase(card: str) -> tuple[dict, dict]:
    """Write synthetic checkpoints at the published widths and names
    (random weights from seeds, through ``synthetic_checkpoints.py``'s
    exporters and the port's safetensors writer) into a temporary hub
    cache, one family at a time; load each on the card through the
    package's loaders (resolved by id through ``HF_HUB_CACHE``), holding
    every tensor bit-equal to the one written and printing bytes, seconds,
    GB/s and peak RSS; serve runs L and M (Qwen3-TTS Base and VoiceDesign)
    and N (CSM-1B) from those snapshots. Each snapshot is deleted after
    its run. Returns (load numbers, run results)."""
    import json as _json
    import shutil
    import tempfile

    import torch

    import synthetic_checkpoints as synth
    from vox_serve_tpu_torch.codecs.mimi import (MimiConfig, init_mimi,
                                                 init_mimi_encoder)
    from vox_serve_tpu_torch.codecs.qwen3_codec import (Qwen3CodecConfig,
                                                        init_qwen3_codec)
    from vox_serve_tpu_torch.codecs.snac import SNACConfig, init_snac_decoder
    from vox_serve_tpu_torch.encoders.ecapa import EcapaConfig, init_ecapa
    from vox_serve_tpu_torch.models.backbone import (BackboneConfig,
                                                     seeded_generator)
    from vox_serve_tpu_torch.models.csm import CSMLM
    from vox_serve_tpu_torch.models.orpheus import OrpheusLM
    from vox_serve_tpu_torch.models.qwen3_tts import Qwen3TTSLM
    from vox_serve_tpu_torch.watermark import silentcipher as sc
    from vox_serve_tpu_torch.watermark import spectral

    dev = torch.device("cuda")
    cache = Path(tempfile.mkdtemp(prefix="vox_hub_"))
    saved_env = os.environ.get("HF_HUB_CACHE")
    os.environ["HF_HUB_CACHE"] = str(cache)
    loads, runs = {}, {}

    def write(model_id, state, shards):
        snap = synth.snapshot_dir(cache, model_id)
        t0 = time.perf_counter()
        synth.write_shards(snap, state, shards)
        return snap, time.perf_counter() - t0

    try:
        # -- Qwen3-TTS Base: talker, depth, speaker encoder; the codec ----
        src = Qwen3TTSLM(QWEN3_BASE, device=dev, seed=21)
        spk = init_ecapa(EcapaConfig(mel_dim=128, enc_dim=2048),
                         seeded_generator(dev, 22), dev)
        state = synth.export_qwen3(src.params, spk, torch.bfloat16)
        snap, ws = write(QWEN3_BASE, state, 2)
        (snap / "config.json").write_text(_json.dumps({"talker_config": {
            "spk_id": {"ryan": 2090, "vivian": 2091, "serena": 2092}}}))
        loads[QWEN3_BASE] = timed_load(
            QWEN3_BASE, _files(snap), src._load_checkpoint, state,
            lambda t: synth.export_qwen3(t, src._spk_enc_params,
                                         torch.bfloat16), ws)

        g = seeded_generator(dev, 23)
        codec = init_qwen3_codec(Qwen3CodecConfig(), g, dev)
        enc = init_mimi_encoder(MimiConfig(), g, dev)
        cstate = {**synth.export_qwen3_codec(codec),
                  **synth.export_mimi_encoder(enc, "encoder.")}
        csnap, ws = write(QWEN3_CODEC, cstate, 1)
        loads[QWEN3_CODEC] = timed_load(
            QWEN3_CODEC, _files(csnap), src._load_codec_params, cstate,
            lambda t: {**synth.export_qwen3_codec(t),
                       **synth.export_mimi_encoder(src._codec_encoder,
                                                   "encoder.")}, ws)
        if src._enc_mimi_cfg != MimiConfig():
            raise AssertionError("the codec encoder's config changed")
        del src, spk, codec, enc, cstate
        _free()
        runs["L"] = end_to_end(card, "L", hub=str(cache))

        # -- VoiceDesign: the same talker, no speaker encoder -------------
        _drop_snapshot(cache, QWEN3_BASE)
        design = {k: v for k, v in state.items()
                  if not k.startswith("speaker_encoder.")}
        del state
        write(QWEN3_DESIGN, design, 2)
        del design
        _free()
        runs["M"] = end_to_end(card, "M", hub=str(cache))
        _drop_snapshot(cache, QWEN3_DESIGN)
        _drop_snapshot(cache, QWEN3_CODEC)

        # -- CSM-1B with the Mimi codec and encoder, and its prompts ------
        src = CSMLM(CSM_ID, device=dev, seed=31)
        g = seeded_generator(dev, 32)
        codec = init_mimi(MimiConfig(), g, dev)
        enc = init_mimi_encoder(MimiConfig(), g, dev)
        state = synth.export_csm(src.params, codec, enc)
        snap, ws = write(CSM_ID, state, 2)
        (snap / "prompts").mkdir()
        for i, name in enumerate(("conversational_a", "conversational_b")):
            (snap / "prompts" / f"{name}.wav").write_bytes(
                synth_wav(CSM_PROMPT_SAMPLES, seed=1 + i))

        def csm_reexport(t):
            shared = synth.share_mimi_codebooks(t["codec"], t["encoder"])
            for grp in ("rvq_first", "rvq_rest"):
                for k in ("embed_sum", "usage"):
                    if not torch.equal(shared[grp][k], t["encoder"][grp][k]):
                        raise AssertionError("encoder codebooks differ")
            return synth.export_csm(t["params"], t["codec"], t["encoder"])

        loads[CSM_ID] = timed_load(CSM_ID, _files(snap), src._load_checkpoint,
                                   state, csm_reexport, ws)
        del src, codec, enc, state
        _free()
        runs["N"] = end_to_end(card, "N", hub=str(cache))
        _drop_snapshot(cache, CSM_ID)

        # -- Orpheus-3B at full width, 4 of its 28 layers; SNAC -----------
        cfg4 = BackboneConfig(
            vocab_size=156940, hidden_size=3072, num_layers=4, num_heads=24,
            num_kv_heads=8, head_dim=128, intermediate_size=8192,
            rope_theta=500000.0, llama31_rope_scaling=True)
        src = OrpheusLM(ORPHEUS_ID, device=dev, seed=41, debug_backbone=cfg4)
        state = synth.export_orpheus(src.params)
        snap, ws = write(ORPHEUS_ID, state, 2)
        loads[ORPHEUS_ID + " (4 of 28 layers)"] = timed_load(
            ORPHEUS_ID, _files(snap), src._load_params, state,
            synth.export_orpheus, ws)
        _drop_snapshot(cache, ORPHEUS_ID)
        del state

        snac = init_snac_decoder(SNACConfig(), seeded_generator(dev, 42), dev)
        sstate = synth.export_snac(snac, SNACConfig())
        snap = synth.snapshot_dir(cache, SNAC_ID)
        t0 = time.perf_counter()
        torch.save(sstate, snap / "pytorch_model.bin")
        loads[SNAC_ID] = timed_load(
            SNAC_ID, _files(snap), src._load_snac, sstate,
            lambda t: synth.export_snac(t, SNACConfig()),
            time.perf_counter() - t0)
        _drop_snapshot(cache, SNAC_ID)
        del src, snac, sstate

        # -- SilentCipher at the 512-row message band ----------------------
        scfg = sc.SilentCipherConfig(message_band_size=512)
        scp = sc.init_silentcipher(scfg, seeded_generator(dev, 43), dev)
        snap = synth.snapshot_dir(cache, SC_ID)
        t0 = time.perf_counter()
        synth.write_silentcipher(snap, scp, scfg)
        ws = time.perf_counter() - t0
        written = {f"{f}:{k}": v for f, sd in
                   synth.export_silentcipher(scp).items()
                   for k, v in sd.items()}

        def sc_reexport(real):
            if real["_sc_cfg"] != scfg:
                raise AssertionError(f"hparams read as {real['_sc_cfg']}")
            return {f"{f}:{k}": v.to(dev) for f, sd in
                    synth.export_silentcipher(real["sc"]).items()
                    for k, v in sd.items()}

        loads[SC_ID] = timed_load(
            SC_ID, _files(snap),
            lambda: spectral._try_load_real_silentcipher(
                spectral.WatermarkConfig(), dev),
            {k: v.to(dev) for k, v in written.items()}, sc_reexport, ws)
        _drop_snapshot(cache, SC_ID)
        del scp, written

        # -- CosyVoice2-0.5B: the LM, flow.pt, hift.pt, S3 v2, CAMPPlus ----
        loads[COSY_ID], runs["P"] = cosy_checkpoint(card, cache, dev)
        _drop_snapshot(cache, COSY_ID)

        # -- GLM-4-Voice-9B: the LM (4 of 40 layers), the decoder, the
        # Whisper-VQ tokenizer; run R from the last two -------------------
        glm_loads, runs["R"] = glm_checkpoint(card, cache, dev)
        loads.update(glm_loads)
        _drop_snapshot(cache, GLM_DECODER)
        _drop_snapshot(cache, GLM_TOKENIZER)

        # -- Step-Audio-2-mini: the LM (4 of 28 layers) with the audio
        # encoder, token2wav; run T from that snapshot ---------------------
        step_loads, runs["T"] = step_checkpoint(card, cache, dev)
        loads.update(step_loads)
        _drop_snapshot(cache, STEP_ID)

        # -- Chatterbox: T3 with cond_enc, s3gen, conds.pt; Perth; run V ---
        chat_loads, runs["V"] = chatterbox_checkpoint(card, cache, dev)
        loads.update(chat_loads)
        _drop_snapshot(cache, CHATTERBOX_ID)
        _drop_snapshot(cache, PERTH_ID)

        # -- Zonos-v0.1: the LM with its conditioner, DAC, the speaker
        # net; run X -------------------------------------------------------
        zonos_loads, runs["X"] = zonos_checkpoint(card, cache, dev)
        loads.update(zonos_loads)
    finally:
        if saved_env is None:
            os.environ.pop("HF_HUB_CACHE", None)
        else:
            os.environ["HF_HUB_CACHE"] = saved_env
        shutil.rmtree(cache, ignore_errors=True)
    return loads, runs


def main(argv=None) -> int:
    import argparse

    import torch
    import torch.distributed

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="the attention kernels' checks only (no backbone, "
                         "no K2, no server); prints no result lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is unavailable", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from vox_serve_tpu_torch.ops import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}"
        f" nccl {torch.distributed.is_nccl_available()} "
        f"{torch.cuda.nccl.version()}")

    t0 = time.perf_counter()
    path = kernels.build(verbose=True)
    log(f"build: {path} in {time.perf_counter() - t0:.1f} s")
    marks = [("build", time.perf_counter())]
    for line in kernels.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    decode = {v: check_decode(kernels, v) for v in DECODE_VARIANTS}
    k3 = check_k3(kernels)
    # Orpheus's GQA group of 3 at its served shapes; Step-Audio-2-mini's
    # Qwen2.5-7B: 28 heads over 4 (G = 7: two decode CTAs of 4 + 3 heads
    # per KV head; 4 or 9 tokens per K3 tile) at head dim 128
    check_decode(kernels, "K1", H=24, KH=8, batches=(4, 64))
    check_decode(kernels, "K1", H=28, KH=4, batches=(4, 64))
    check_k3(kernels, H=24, KH=8, shapes=((168, 4), (1024, 5)))
    check_k3(kernels, H=28, KH=4, shapes=((168, 4), (1024, 5)))
    # CSM-1B's served heads: a GQA group of 4 at head dim 64
    check_decode(kernels, "K1", H=32, KH=8, batches=(4, 64), D=64)
    check_k3(kernels, H=32, KH=8, shapes=((168, 4), (1024, 5)), D=64)
    # CosyVoice2's Qwen2-0.5B: 14 heads over 2 (G = 7: two decode CTAs of
    # 4 + 3 heads per KV head) at head dim 64
    check_decode(kernels, "K1", H=14, KH=2, batches=(4, 64), D=64)
    check_k3(kernels, H=14, KH=2, shapes=((168, 4), (1024, 5)), D=64)
    # GLM-4-Voice-9B: 32 heads over 2 (G = 16: four decode CTAs of 4 heads
    # per KV head; 2 or 4 tokens per K3 tile) at head dim 128
    check_decode(kernels, "K1", H=32, KH=2, batches=(4, 64))
    check_k3(kernels, H=32, KH=2, shapes=((168, 4), (1024, 5)))
    # Chatterbox's T3: 16 heads over 16 (G = 1: one head per decode CTA; 32
    # or 64 tokens per K3 tile) at head dim 64
    check_decode(kernels, "K1", H=16, KH=16, batches=(1, 4, 8, 64), D=64)
    check_k3(kernels, H=16, KH=16, shapes=((168, 4), (1024, 5)), D=64)
    # Zonos-v0.1: 16 heads over 16 (G = 1: one head per decode CTA; 32 or
    # 64 tokens per K3 tile) at head dim 128
    check_decode(kernels, "K1", H=16, KH=16, batches=(1, 4, 8, 64))
    check_k3(kernels, H=16, KH=16, shapes=((168, 4), (1024, 5)))
    # one rank's heads at --tp-size 4: the flagship's 4 over 2 (G = 2) and
    # GLM-4-Voice-9B's 8 over its one KV head (G = 8: two decode CTAs of 4
    # heads; 4 or 8 tokens per K3 tile)
    check_decode(kernels, "K1", H=4, KH=2, batches=(4, 64))
    check_decode(kernels, "K1", H=8, KH=1, batches=(4, 64))
    check_k3(kernels, H=4, KH=2, shapes=((168, 4), (1024, 5)))
    check_k3(kernels, H=8, KH=1, shapes=((168, 4), (1024, 5)))
    k6 = check_k6(kernels)
    if args.kernels_only:
        return 0
    marks.append(("attention kernels", time.perf_counter()))
    for kv in ("combined", "int8", "f8_e4m3", "pair"):
        check_backbone(kv)
    check_backbone("combined", heads="orpheus")
    check_backbone("combined", heads="csm")
    check_backbone("combined", heads="orpheus", weight_quant="int8")
    marks.append(("backbones", time.perf_counter()))
    check_tp_backbone(kernels)
    marks.append(("TP backbones", time.perf_counter()))
    k5 = check_k5(kernels)
    marks.append(("K5", time.perf_counter()))
    k2 = check_k2()
    k2h = check_k2("bfloat16")
    marks.append(("K2", time.perf_counter()))
    check_codec()
    marks.append(("codec", time.perf_counter()))

    # the main path runs in each server's daemon, whose counters start at 0
    # (comparison launches above happened in this process and do not count)
    runs = {}
    for c in RANDOM_RUNS + PROFILE_RUN:
        runs[c] = end_to_end(card, c)
        marks.append((f"run {c}", time.perf_counter()))
    _loads, ckpt_runs = checkpoint_phase(card)
    marks.append(("checkpoints, L, M, N, P, R, T, V, X",
                  time.perf_counter()))
    runs.update(ckpt_runs)
    runs.update(two_card_phase(card))
    marks.append(("two cards", time.perf_counter()))
    runs.update(four_card_phase(card, runs))
    marks.append(("four cards", time.perf_counter()))
    log("seconds per phase: " + ", ".join(
        f"{name} {t - prev:.1f}" for (name, t), (_, prev)
        in zip(marks[1:], marks)) + f"; all after the build "
        f"{marks[-1][1] - marks[0][1]:.1f}")
    total = {name: sum(r["launches"][name] for r in runs.values())
             for name in runs["A"]["launches"]}
    a, e = runs["A"], runs["E"]
    ratio = e["frames_per_s"] / a["frames_per_s"]
    log(f"E vs A: {e['frames_per_s']:.1f} / {a['frames_per_s']:.1f} frames/s"
        f" = {ratio:.3f} ({'within' if ratio >= 0.8 else 'NOT within'} 20% "
        f"of A; recorded, not a failure)")
    log(f"F solo-stream TTFA {runs['F']['solo_ttfa_s'] * 1e3:.1f} ms vs A's "
        f"4-stream TTFA median {a['ttfa_median_s'] * 1e3:.1f} ms")
    g = runs["G"]
    log(f"G text-stream TTFA {max(g['text_stream_ttfa']) * 1e3:.1f} ms (the "
        f"later of two) vs its /generate streams' "
        f"{max(g['generate_ttfa']) * 1e3:.1f} ms")
    i_run, y_run = runs["I"], runs["Y"]
    share = y_run["backbone_bytes"] / i_run["backbone_bytes"]
    log(f"Y vs I (int8 vs bf16 backbone): backbone {y_run['backbone_bytes']}"
        f" / {i_run['backbone_bytes']} bytes = {share:.4f}; windows/s "
        f"{y_run['frames_per_s']:.2f} / {i_run['frames_per_s']:.2f}; TTFA "
        f"median {y_run['ttfa_median_s'] * 1e3:.1f} / "
        f"{i_run['ttfa_median_s'] * 1e3:.1f} ms; decode step wall "
        f"{y_run['decode_step_ms']:.2f} / {i_run['decode_step_ms']:.2f} ms; "
        f"memory after the model's init (bf16, before the worker "
        f"quantizes) {y_run['init_memory_gb']} / {i_run['init_memory_gb']}"
        " GB")
    if share > 0.55:
        raise AssertionError(f"Y's int8 backbone is {share:.4f} of I's "
                             "bf16 bytes (at most 0.55)")

    def quant_worst(key):
        return max(decode["K1q int8"][key], decode["K1q f8_e4m3"][key])

    k1q = {**decode["K1q int8"], "max_abs_err": quant_worst("max_abs_err")}
    print(json.dumps({"kernels": [
        {"name": K1, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vox_serve_tpu/ops/attention.py:246",
         "launches": total[K1], **decode["K1"]},
        {"name": K1Q, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vox_serve_tpu/ops/attention.py:300",
         "launches": total[K1Q], **k1q},
        {"name": K3, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/ragged_prefill.cu",
         "replaces": "vox_serve_tpu/ops/pallas_prefill.py:148",
         "launches": total[K3], **k3},
        {"name": K4, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/paged_decode.cu",
         "replaces": "vox_serve_tpu/ops/pallas_attention.py:290",
         "launches": total[K4], **decode["K4"]},
        {"name": K2, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/resunit.cu",
         "replaces": "vox_serve_tpu/ops/pallas_resunit.py:150",
         "launches": total[K2], **k2},
        {"name": K2H, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/resunit.cu",
         "replaces": "vox_serve_tpu/ops/pallas_resunit.py:150",
         "launches": total[K2H], **k2h},
        {"name": K5, "route": "cuda",
         "source": "vox_serve_tpu_torch/csrc/w8a16_linear.cu",
         "replaces": "vox_serve_tpu/models/backbone.py:83",
         "launches": total[K5], **k5},
        *({"name": name, "route": "cuda",
           "source": "vox_serve_tpu_torch/csrc/depth_layer.cu",
           "replaces": "vox_serve_tpu/models/depth.py:110",
           "launches": total[name], **k6[name]} for name in K6),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
