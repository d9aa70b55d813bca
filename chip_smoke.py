#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (magicdec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line of numbers (all must pass, or the script
exits non-zero):
  1. build      nvcc builds every kernel of csrc/ (one process per source)
 Phases 2-4, 8 and 8c run at llama-3.2-1b's heads (Hq=32, Hkv=8, D=64) and
 again at llama-3.1-8b's (Hq=32, Hkv=8, D=128), with the same limits,
 planted faults and bit checks; the bf16 decode and prefill kernels are also
 launched with their planted pipeline fault (the last tile of each split, or
 of each prefill CTA's walk, copied into its ring stage but never computed),
 which the limit must reject.
  2. decode     flash_decode_stacked vs its plain version at each head dim,
                B=8, S=4224, ragged lengths,
                T in {1, 7}, bf16 and f32, flat and peaked softmax; then
                bit-exact row independence (T=1 rows vs the same rows in T=7)
                and capacity independence (caches of S=1088, 1152 (the
                main path's draft cache) and 4224 holding the same prefix)
  3. intervals  flash_decode_intervals vs its plain version on the
                StreamingLLM draft cache (S=1088), T in {1, 2}, bf16 and
                f32, flat and peaked, sink + gap + window rows with separate
                sink K rows; the limit must reject a missed window tile and
                a missed sink; and T=1/T=2 rows with intervals reducing to
                [0, hi) must give the bits of flash_decode_stacked's T=7
                rows (flat caches of 1088 and 4224 slots)
  4. masked     flash_decode_stacked_masked vs its plain version on the
                Quest draft's round buffer (NS=896 top columns + a 192-slot
                tail: R=1088), T in {1, 2}, bf16 and f32, flat and peaked,
                random 70% top bits, ragged tails; the limit must reject the
                kernel run with an all-ones colmask (a kernel that ignores
                the bits), and with an all-ones colmask and a = lo = 0 the
                masked kernel must give flash_decode_stacked's bits
  5. gather     page_gather bit-exact against its plain version at head_dim
                64 and 128 (7 of the 33 pages of 128 rows of a 4224-slot
                layer, and 7 of 64 pages of 66 rows, which are no multiple
                of the kernel's 16 KB chunk; repeated and out-of-order pages, the
                last page and indices past both ends, clamped), bf16 and
                f32, into new tensors and into a round buffer's top region;
                every destination is first filled with 0xFF bytes (new
                tensors: the caching allocator's freed blocks, and a launch
                into filled tensors), and the kernel launched with its
                planted fault (each unit's last chunk dropped) must fail
                the same checks; a ring beyond the kernel's limits must be
                refused
  6. gather1   page_gather_single the same way (28 of the 130 clusters of
                the main path's KV-fused store, pages of 2cap = 64 rows and
                of 66), into a new tensor and split into a round buffer's K
                and V top regions
  7. scores     centroid_scores vs its plain version in f32 (q bf16 and f32,
                T in {1, 7}, the main path's 130 centroids and 1024, D 64 and
                128, as a strided view, flat and peaked softmax) within 1e-5
                + 1e-5 |plain|; where scores_plan splits C over a cluster,
                the limit must reject the scores with the last rank left out
                of the rows' (max, sum of exp) combine
  8. prefill    flash_prefill vs its plain version, T=128 chunks at several
                s_cap buckets, bf16 and f32, flat and peaked softmax.
                Phases 2-4 and 8 hold each output against the plain version
                in f32 with the per-element limit of fd.plain_f32_and_limit
                (the same bound for the intervals and masked forms), and
                check that the limit rejects an output that misses each long
                row's last 64-slot tile.
  8a. int4      int4_matmul vs its plain version at llama-3.2-1b's and
                llama-3.1-8b's four product shapes, M in {8, 56, 64, 256,
                1024}, bf16 and f32 x, within
                int4_matmul_plain_f32_and_limit; M=8 rows bit-equal to the
                same rows inside M = 56, 256 and 1024; the limit must reject
                the output with one group's -8 rowsum correction left out
                and the output with the last K split's partial left out
  8b. fused     fused_qkv (with and without a bias) and fused_post_attn vs
                their plain versions at llama-3.2-1b's widths (bf16 and f32)
                and llama-3.1-8b's (bf16), M in {8, 56}: every element within
                fused_*_plain_f32_and_limit and the mean error within
                MEAN_LIMIT; M=8 rows bit-equal to the same rows inside M=56;
                the limit must reject bf16 fused_qkv and fused_post_attn
                launched with their planted fault (the last K split's
                partial left out of each split product's sum)
  8c. lse       the return_lse forms against their plain versions at the
                GliDe shapes: flash_decode_stacked at T=7 and T=29 (two
                launches, attention_impls.flash_stacked_lse) over a 4224-slot
                stacked cache, flash_decode_intervals at T in {1, 2, 4, 8,
                16} over a 4224-slot flat own cache's prefix, bf16 and f32,
                flat and peaked, an empty row each: ctx within
                plain_f32_and_limit and bit-equal with and without the flag,
                m and l within fd.lse_limits, empty rows l == 0 and ctx 0, a
                planted fault (l of a merge skipping the last split) rejected,
                merge_lse of two halves within twice the one-pass limit
  9. reference  a small f32 model: logits of the card's path (kernels, cuBLAS)
                vs the CPU plain path, with plain weights unfused and fused,
                and int8 and int4 weights; Quest on it (B=2, P=512, 32 new
                tokens, gamma 3, budget P + 128 = full coverage): lossless
                and accepting >= 0.9; RetroInfer on it on the fold path
                (TAIL_COVERS_MAX lowered to 0: 72 new tokens, latest_k 32,
                the tail compacts and aged rows join the index): lossless
  10. gemm rows each row-wise product of a decode step at llama-3.2-1b
                widths, for (B, gamma) = (8, 6) and (16, 4): do M=B rows get
                the bits of the same rows inside M=B*(gamma+1), unpadded,
                padded each to a multiple of 64, and padded as the port pads
                (llama.row_bucket: B * 32 rows rounded up to 64 for every
                decode-phase forward), and the ms of each (the padding's
                cost); fails if the port's padded rows differ
  11. main path llama-3.2-1b at full width (random bf16 weights from a seeded
                torch.Generator), B=8, P=4096, 64 new tokens, gamma=6:
                generate_autoregressive, generate_selfspec with SnapKV
                (budget 1024 and full budget = P), with StreamingLLM (sink
                16, budget 1024, whose 1088-slot draft window compacts, and
                full budget P + 64 + gamma + 4), with Quest (budget 1024:
                7 pages + a 128-row tail, and full coverage P + 128; each
                compacts its tail once), and with RetroInfer and
                SqueezedAttention (budget 1024: 28 of 130 clusters of 32
                rows + a 128-row tail; the index build is timed apart).
                Every speculative stream must equal
                the AR stream, SnapKV's and StreamingLLM's full budgets must
                accept exactly 1.0 (Quest's full coverage is printed: its
                draft reads the pages in another order than the verify), and
                each run's kernel launch counts (zeroed before it) must be
                those its path implies (every decode forward on the fused
                pair, the default route). Then B=16, gamma=4 (the JAX
                package's production_shape defaults; P cut to 1024): AR and
                SnapKV at budget 1024 = full budget, lossless and accepting
                exactly 1.0.
 11a. hf_ruler  the tail on the main path: the main path's weights written
                as an HF checkpoint directory named llama-3.2-1b (two
                safetensors shards and their index, by this script's own
                writer) and loaded back by checkpoint/convert_hf's
                load_hf_checkpoint with no config and no device, and a
                pytorch_model.bin of the first 2 layers loaded with a
                2-layer config: every leaf bit-equal to the source params;
                then RULER niah prompts (data/ruler.py, B=8, P=4096)
                through AR and SnapKV 1024 (gamma 6, 64 new tokens) on the
                loaded weights: the SnapKV stream equals AR, the RULER
                scores are equal (both printed), launch counts as the path
                implies; PhaseClock times the loads, a prefill and both
                runs, device_trace traces a one-round SnapKV run on the
                .bin's 2 layers (the trace must name the hand-written
                decode and prefill kernels and the fused block's product),
                step_cost_report times an AR step; then
                analysis.selection_fidelity on the prefilled cache's layer
                0 and the last prompt position's rotated query (8 pages of
                128: per-head true mass >= joint and >= per-head boxes,
                all in [0, 1]) and find_alpha / best_gamma from the SnapKV
                acceptance
 12. longspec   two-model SD with llama-3.2-1b as the target: a self-draft
                (the same weights, full KV) must accept exactly 1.0, and a
                2-layer draft of the same widths with its own weights must
                be lossless in each draft mode (full, snapkv 1024,
                streaming 1024); launch counts as the path implies.
 12a. quant     llama-3.2-1b quantized on the card from the main path's
                weights: int8 (AR, SnapKV full) and int4 (AR, SnapKV 1024 and
                full), then the main path's bf16 weights under
                set_fused_mode("off") (AR, SnapKV 1024 and full, on rows
                padded to llama.row_bucket): each spec stream equals its own
                AR stream, full budget accepts exactly 1.0, launch counts as
                the path implies (int4_matmul 4 L per forward, no fused
                pair)
 12b. glide     GliDe on the main path's model with a random glide block
                (seed 5, scale 0.3): linear (gamma 6), greedy tree (2,2) and
                (4,2,2) generations and 4 stochastic tree (2,2) rounds; the
                linear stream equals the AR stream, the tree streams' share
                matching AR before a divergence is printed, the stochastic
                rounds emit 1..depth+1 tokens and advance both caches by it;
                launch counts as each path implies
 12c. glide_f32 the same model in f32 weights and caches, P cut to 1024: the
                tree (2,2) stream equals the f32 AR stream
 12h. serve     continuous batching (engine/serve.py) on the main path's
                model: a B=8 frame, P=4096, gamma 6, 16 requests with
                max_new_tokens cycled from benchmarks/serve_benchmark.py's
                spread (16..128). At budget 1024, static batching (groups
                of 8 run to their longest member) against ServeEngine:
                useful tokens/s, rounds, occupancy, one host read a round;
                at full budget (budget = P) acceptance exactly 1.0; 4
                requests alone (B=1, full budget): each served stream's
                share matching its solo stream before a divergence; launch
                counts as the rounds and admissions imply (flash_prefill
                L x P/128 an admission, flash_decode_stacked L x (gamma+1)
                a round)
 12i. offload   host offload (engine/offload.py) on the main path's model,
                B=8, P=4096: the layer-at-a-time prefill into the host wave
                buffer (64 x 64 clusters a layer and sequence, a 512-row
                tail; flash_prefill L x P/128; its peak memory beside an
                Engine.encode's), then 32 tokens of offload_generate (equal
                to its device twin), offload_generate_hostloop (equal to
                it, and through a 10-slot ClusterLRU that must evict) and
                offload_generate_spec with gamma 4 (equal to the hostloop
                stream, with and without a ClusterLRU of the round's
                union, 40 of the 64 clusters, that must cut the host
                fetches); tok/s, host fetches and bytes a step, the pinned
                copy's and the host gather's GB/s
 12d. llama8b   the head_dim-128 path at full width: llama-3.1-8b (32
                layers, dim 4096, 32/8 heads, FFN 14336, vocab 128256),
                random bf16 weights (seed 0), B=8, P=4096, 64 new tokens,
                gamma 6: AR, SnapKV 1024 and full budget, StreamingLLM full
                budget, Quest 1024, RetroInfer 1024 and a GliDe tree (2,2)
                generation; every stream but the tree's equals the AR
                stream, the full budgets accept exactly 1.0, launch counts
                as each path implies (they
                are the launches of the head_dim-128 kernel entries); then
                the step profile of an AR step and a SnapKV round
 12e. tensor_parallel  llama-3.1-8b at full width, its first 16 of 32
                layers (TP8B_LAYERS: the script's time), in a world of two
                ranks on the one card (parallel/launch.run_world: two processes,
                gloo over CUDA tensors, each rank drawing its shard of the
                seeded weights a layer at a time), B=8, P=4096, 16 new
                tokens (two ranks share the card), gamma 6: AR, SnapKV 1024
                and full budget, StreamingLLM full budget, Quest 1024,
                RetroInfer 1024 and two-model SD with a 2-layer draft
                replicated on both ranks; the ranks' streams and logits
                equal, every speculative stream equal to the tp AR stream,
                full budgets exactly 1.0, each rank's launch counts as its
                path implies (every launch through a per-shard form), the
                first decode step's logits bit-equal to llama8b's (tp=1,
                on the unfused route the tp ranks take) with the
                row-parallel partials rounded as tp=2 rounds them
                (_TpRounding); their distance to plain tp=1's and the share
                of the tp AR stream equal to tp=1's are printed
 12j. tp_1b     llama-3.2-1b at full width in a world of two ranks on the
                one card (gloo), B=8, P=4096, 16 new tokens, gamma 6:
                SqueezedAttention 1024, GliDe linear and tree (2,2) with the
                glide phase's random block, the f32 tree (2,2) at P=1024,
                int8 and int4 SnapKV 1024 and full budget (the weights
                quantized whole, then cut by the Engine); the ranks' streams
                equal, each speculative stream equal to its tp AR stream
                (the f32 tree's to the f32 one; the bf16 tree's share is
                printed), full budgets exactly 1.0, the bf16, int8 and int4
                first decode step's logits bit-equal to tp=1's under
                _TpRounding, each rank's launch counts as its path implies
                (int4_matmul at the tp=2 shard shapes, which it checks)
 12k. dp_tp     the same model in a world of four ranks on the one card, a
                dp=2 x tp=2 mesh (each rank 4 of the 8 rows and its heads):
                AR, SnapKV 1024 and full budget, StreamingLLM full budget;
                the gathered [B, N] streams equal on every rank, lossless,
                full budgets exactly 1.0, the share of rows equal to
                tp_1b's AR printed; the sub-mesh make_mesh(dp=1, tp=2) of
                ranks 0-1 (ranks 2-3 get None) gives tp_1b's AR stream
 12f. nccl_world_of_one  one rank with the nccl backend: an all-reduce, then
                llama-3.2-1b AR (8 tokens) with the mesh bit-equal to the
                stream without it
 12g. trained   training on the card (magicdec_tpu_torch/train.py). First
                train_card_vs_cpu: three make_train_step steps of the
                small f32 model on the card and on the CPU on the same
                batches: losses within 1e-5 relative, first moments within
                1e-4 of each leaf's largest element, params within 1e-4 of
                each leaf's update (mean over mean); the same steps with
                TF32 on must fail that.
                Then bench.py's BENCH_MODEL (bench.py:57-59) at full width
                trained with bench.py's protocol cut to TRAIN_STEPS steps
                (mixed_markov_dataset(2048, 2048, seed 7), batch 8, lr
                1e-3, f32, remat, TF32 off; no kernel launched): the loss
                at steps 0, N/2 and N, which must end below 4.0 nats, ms a
                step, tokens/s, peak memory and the 1200-step protocol's
                projected time; its bf16 cast saved with save_params and
                loaded back bit for bit; on held-out prompts
                (mixed_markov_dataset(4096, 8, seed 10_000)) AR and SnapKV
                at budget 1024 and full budget with the trained weights
                (lossless, full budget exactly 1.0, launch counts, the
                acceptance and tok/s beside the main path's random-weight
                run); a GliDe block trained against the frozen target for
                GLIDE_STEPS steps (mixed_markov_dataset(1024, 1024, seed
                7)): its loss must fall and flash_prefill launch n_layer
                times a step (the target's forward); then GliDe linear
                rounds with it (stream = AR, acceptance printed)
 13. times      each kernel at the main path's shapes (the attention kernels
                at both head dims: `times` and `times_d128`): kernel, plain version,
                bound (bytes / 3.35 TB/s vs FLOPs / 989 TFLOP/s bf16, or 67
                TFLOP/s for centroid_scores' f32 work) and one PyTorch call
                on the same work as a yardstick where there is one (the port
                never calls it: scaled_dot_product_attention for attention,
                index_select for the gathers), each on the device (32 calls
                replayed from a CUDA graph); the kernel also launched from
                Python (eager_ms, the host's launch pace included); the
                StreamingLLM sink twist against a whole-layer copy; then
                int4_matmul at both models' four products, M in {8, 64, 256,
                512, 1024} and 56 (yardsticks: torch._weight_int4pack_mm and
                the bf16 mm of the dequantized weight; a layer's four
                products summed at 64 and at the B=8 bucket, 256; a sweep
                of every split count at 64 and 256 rows against the
                plan's) and the fused pair at both models' widths, M = 8 and
                56 (yardstick: the unfused chain, two or several calls;
                each kernel of a call alone: fused_qkv's sums of squares and
                product, fused_post_attn's three passes; each whole call at
                several CTA aims of its split plan, the qkv product and the
                wo and w_down passes at each split count, and whether CUDA
                graph capture keeps the programmatic launch edges between a
                call's kernels); centroid_scores against C (32, 130, 520,
                1024) with the bound and the plain version at each C and
                the whole call at several aims of scores_plan; the fused
                pair at llama-3.1-8b's widths at the decode rows of B=32
                (M = 32, 160 and 928: AR and draft steps, a gamma 4 verify,
                a GliDe tree (4,2,2) verify), each kernel alone, beside the
                unfused chain at the 1024 rows it pads them to, and a
                forward's products both ways (`decode_rows`; M=32 rows
                bit-equal inside 160 and 928); and the
                return_lse forms at the GliDe shapes (SDPA, which returns no
                (m, l), as the yardstick). The gathers are timed at both
                head dims (the D=128 page_gather is the llama-3.1-8b Quest
                path's)
 13a. gather_variants  the gather kernel's geometries (GATHER_VARIANTS:
                bulk async copies at several chunk sizes, ring depths and
                CTAs an SM) on both gathers' timed shapes at both head
                dims, each bit-checked, with index_select timed in the same
                call
 13c. times_int4_tp2  int4_matmul at llama-3.2-1b's tp=2 shard shapes (the
                four products tp_1b's ranks ran), 128 and 256 rows, within
                its limit, timed beside its plain version, its bound and
                the two yardsticks
 13b. sharded_kernels  each per-shard form (flash_stacked_lse among them)
                at llama-3.1-8b's heads cut into
                tp=2 and tp=4 shards: the shards' outputs concatenated
                bit-equal to the kernel's on the whole tensors, each shard
                within its plain version's limit; each form timed at the
                tp=2 shard (graph device ms, plain, bound, SDPA or
                index_select) beside the kernel on the whole tensors at the
                same lengths
 14. profile    device-busy share, launches, top kernels and top host ops
                of an AR step (bf16 fused, int8, int4, bf16 unfused), of a
                GliDe tree (2,2) round and of a SnapKV, a Quest and a
                RetroInfer round at budget 1024 (torch.profiler)
Then each phase's seconds, the card's name and power limit (nvidia-smi),
one JSON line of the kernels, and the last line {"ok": true, "device":
{...}}.

Exits non-zero without printing a result when no GPU is available or when
the repository's package is not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), used for bound_ms
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12                     # outside the tensor cores

B, P, NEW, GAMMA, BUDGET, WINDOW, SINK = 8, 4096, 64, 6, 1024, 32, 16
MAX_LEN = P + NEW + 2 * GAMMA + 16          # Engine rounds this up to 4224
STREAM_HEADROOM = 64                        # the Engine's draft_headroom
DRAFT_SLOTS = BUDGET + STREAM_HEADROOM      # the StreamingLLM draft cache
STREAM_FULL = P + NEW + GAMMA + 4           # a budget that evicts nothing
DRAFT_LAYERS = 2                            # the longspec phase's small draft
QUEST_PAGE, QUEST_TAIL = 128, 128           # Engine's quest_page, latest_k
QUEST_NS = (BUDGET // QUEST_PAGE - QUEST_TAIL // QUEST_PAGE) * QUEST_PAGE
QUEST_WCAP = -(-(QUEST_TAIL + 8 * (GAMMA + 2)) // 8) * 8  # the tail region
QUEST_R = QUEST_NS + QUEST_WCAP             # the round buffer: 896 + 192
QUEST_FULL = P + QUEST_PAGE                 # full coverage: every page
RETRO_CAP = 32                              # Engine's retro_cap
RETRO_C = max(MAX_LEN // 32, 8)             # Engine's clusters: 130
RETRO_N = (BUDGET - QUEST_TAIL) // RETRO_CAP  # clusters gathered: 28
RETRO_NS = RETRO_N * RETRO_CAP              # = QUEST_NS, 896 top columns
# query scales of the kernel checks: logits of std 0.5 (a flat softmax over
# thousands of slots, outputs ~0.02) and of std 3 (a peaked one, outputs ~1)
Q_SCALES = {"flat": 1.0, "peaked": 6.0}
# rows longer than this lose their last 64-slot tile in the planted fault
FAULT_MIN_LEN = 1024
# the attention kernels' head dims: llama-3.2-1b's (the main path) and
# llama-3.1-8b's (the head_dim-128 path); both at 32 query and 8 KV heads
HEAD_DIMS = (64, 128)
MODEL_OF_D = {64: "llama-3.2-1b", 128: "llama-3.1-8b"}


def _sfx(D):
    """The suffix of a kernel entry's name at head_dim D."""
    return "" if D == 64 else f"_d{D}"


def line(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


class _Clock:
    """Each phase's wall seconds: mark(name) closes the phase that began
    at the previous mark."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def mark(self, name):
        now = time.perf_counter()
        self.seconds[name], self.t = now - self.t, now


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one GPU.")
    ap.add_argument("--protocol", action="store_true",
                    help="run only the build and the trained phase, at "
                         "bench.py's full step counts (PROTOCOL_STEPS and "
                         "PROTOCOL_GLIDE_STEPS) instead of the cut ones")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "magicdec_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(magicdec_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from magicdec_tpu_torch.ops import _build
    clock = _Clock()
    line(phase="build", seconds=_build.build(), sources=list(_build.SOURCES))
    clock.mark("build")
    if args.protocol:
        trained(torch, dev, None, PROTOCOL_STEPS, PROTOCOL_GLIDE_STEPS)
        clock.mark("trained")
        return _finish(torch, clock, None)

    errs = {}
    for D in HEAD_DIMS:
        x = _sfx(D)
        errs["flash_decode_stacked" + x] = check_decode(torch, dev, D)
        errs["flash_decode_intervals" + x] = check_intervals(torch, dev, D)
        errs["flash_decode_stacked_masked" + x] = check_masked(torch, dev, D)
        errs["flash_prefill" + x] = check_prefill(torch, dev, D)
        (errs["flash_decode_stacked_lse" + x],
         errs["flash_decode_intervals_lse" + x]) = check_lse(torch, dev, D)
    errs.update(check_page_gather(torch, dev))
    errs.update(check_page_gather_single(torch, dev))
    errs.update({"centroid_scores": check_centroid_scores(torch, dev),
                 "int4_matmul": check_int4(torch, dev)})
    errs.update(check_fused(torch, dev))
    clock.mark("kernel_checks")
    check_reference(torch, dev)
    quest_small_f32(torch, dev)
    retro_small_f32(torch, dev)
    gemm_rows(torch, dev)
    clock.mark("reference_and_gemm_rows")
    params, prompt = main_inputs(torch, dev)
    launches, ar, random_tok_s = main_path(torch, dev, params, prompt)
    clock.mark("main_path")
    launches = _add(launches, hf_ruler(torch, dev, params))
    clock.mark("hf_ruler")
    launches = _add(launches, longspec(torch, dev, params, prompt, ar))
    launches = _add(launches, quant_and_fused(torch, dev, params, prompt))
    clock.mark("longspec_quant_fused")
    launches = _add(launches, glide(torch, dev, params, prompt, ar))
    launches = _add(launches, glide_f32(torch, dev, params, prompt))
    clock.mark("glide")
    launches = _add(launches, serve(torch, dev, params))
    clock.mark("serve")
    launches = _add(launches, offload(torch, dev, params, prompt))
    clock.mark("offload")
    del params
    torch.cuda.empty_cache()
    train_card_vs_cpu(torch, dev)
    launches = _add(launches, trained(torch, dev, random_tok_s))
    clock.mark("trained")
    launches128, ref8b = llama8b(torch, dev)
    clock.mark("llama8b")
    launches_tp = tensor_parallel(torch, dev, ref8b)
    del ref8b
    clock.mark("tensor_parallel")
    launches_1b, tp_ar = tp_1b(torch, dev)
    clock.mark("tp_1b")
    launches_dp = dp_tp(torch, dev, tp_ar)
    clock.mark("dp_tp")
    nccl_world_of_one(torch, dev)
    clock.mark("nccl_world_of_one")
    kernels = (time_kernels(torch, dev, errs, launches)
               + time_int4(torch, dev, errs, launches)
               + time_int4_tp(torch, dev, launches_1b)
               + time_weight_kernels(torch, dev, errs, launches)
               + time_kernels(torch, dev, errs, launches128, D=128)
               + sharded_kernels(torch, dev, _add(_add(
                   launches_tp, launches_1b), launches_dp)))
    time_decode_rows(torch, dev)
    clock.mark("times_and_sharded_kernels")
    gather_variants(torch, dev)
    step_profile(torch, dev)
    clock.mark("gather_variants_and_profile")
    return _finish(torch, clock, kernels)


def _finish(torch, clock, kernels) -> int:
    """The phases' seconds, the card's name and power limit, the kernels'
    JSON line (when the kernels were timed) and the last line."""
    line(phase="seconds", **clock.seconds)
    print(_card())
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phases 2-8: kernels against their plain versions
# ---------------------------------------------------------------------------

def _cache_inputs(torch, dev, dtype, S, T, seed, q_scale=1.0, L=2, Hkv=8,
                  G=4, D=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn((L, B, S, Hkv * D), generator=g, device=dev) * 0.5
    v = torch.randn((L, B, S, Hkv * D), generator=g, device=dev)
    q = torch.randn((B, T, Hkv * G, D), generator=g, device=dev) * q_scale
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _hold(out, ref, limit):
    """out against the plain version in f32 (ref) under the per-element
    limit: (max abs err, max err / limit, within the limit everywhere)."""
    diff = (out.float() - ref).abs()
    return (float(diff.max()), float((diff / limit).max()),
            bool((diff <= limit).all()))


def _check_out(torch, what, out, ref, limit, errs, ratios):
    """Fail unless out is finite and within the limit; record its errors."""
    if not torch.isfinite(out.float()).all():
        fail(f"{what}: non-finite output")
    errs[what], ratios[what], ok = _hold(out, ref, limit)
    if not ok:
        fail(f"{what}: max abs err {errs[what]} exceeds the limit "
             f"({ratios[what]} times it)")


def _check_case(torch, fd, what, out, q, k, v, layer, valid, s_cap, scale,
                errs, ratios, faults):
    """Hold one kernel output against its plain version; for bf16 with rows
    longer than FAULT_MIN_LEN also check that the limit rejects the output
    of a faulty kernel that skips each such row's last (diagonal) 64-slot
    tile (it must on peaked inputs, where outputs are O(1); on flat ones it
    is reported)."""
    ref, limit = fd.plain_f32_and_limit(q, k, v, layer, valid, s_cap)
    _check_out(torch, what, out, ref, limit, errs, ratios)
    if k.dtype == torch.bfloat16 and bool((valid > FAULT_MIN_LEN).any()):
        cut = torch.where(valid > FAULT_MIN_LEN, (valid - 1) // 64 * 64, valid)
        faulty = fd.attention_plain(q.float(), k.float(), v.float(), layer,
                                    cut.to(torch.int32), s_cap).to(k.dtype)
        faults[what] = not _hold(faulty, ref, limit)[2]
        if scale == "peaked" and not faults[what]:
            fail(f"{what}: the limit does not reject a missed diagonal tile")


def _pipeline_fault(torch, fd, what, q, k, v, layer, valid, s_cap, faults,
                    prefill=False):
    """The bf16 kernel launched with its planted pipeline fault (the last
    tile of each decode split, or of each prefill CTA's walk, copied into its
    ring stage but never computed) must fail the limit that the kernel
    holds; call on peaked inputs."""
    ref, limit = fd.plain_f32_and_limit(q, k, v, layer, valid, s_cap)
    ext = k.shape[2] if s_cap is None else min(s_cap, k.shape[2])
    launch = fd._prefill_launch if prefill else fd._decode_launch
    bad = launch(q, k, v, layer, valid, ext, fault=1)
    faults[f"{what}_dropped_stage"] = not _hold(bad, ref, limit)[2]
    if not faults[f"{what}_dropped_stage"]:
        fail(f"{what}: the limit does not reject the kernel that drops a "
             f"ring stage")


def check_decode(torch, dev, D=64):
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops.attention import decode_valid_upto

    S = 4224
    lens = torch.tensor([4100, 4160, 3, 511, 512, 2049, 4096, 1000],
                        dtype=torch.int32, device=dev)
    errs, ratios, faults = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for T in (1, 7):
            for scale, qs in Q_SCALES.items():
                q, k, v = _cache_inputs(torch, dev, dtype, S, T, seed=T,
                                        q_scale=qs, D=D)
                valid = decode_valid_upto(lens, T)
                for layer in (0, 1):
                    out = fd.flash_decode_stacked(q, k, v, layer, valid)
                    _check_case(torch, fd, f"{name}_T{T}_{scale}_l{layer}", out,
                                q, k, v, layer, valid, None, scale, errs,
                                ratios, faults)
                if dtype == torch.bfloat16 and scale == "peaked":
                    _pipeline_fault(torch, fd, f"{name}_T{T}", q, k, v, 1,
                                    valid, None, faults)
        # bit-exact: rows and capacity
        q, k, v = _cache_inputs(torch, dev, dtype, S, 7, seed=11, D=D)
        small_lens = torch.tensor([1000, 1081, 0, 511, 512, 7, 1024, 64],
                                  dtype=torch.int32, device=dev)
        for lens_case in (lens.clamp(max=S - 7), small_lens):
            valid = decode_valid_upto(lens_case, 7)
            full = fd.flash_decode_stacked(q, k, v, 1, valid)
            for t in range(7):
                one = fd.flash_decode_stacked(q[:, t:t + 1].contiguous(), k, v,
                                              1, valid[:, t:t + 1].contiguous())
                if not torch.equal(one, full[:, t:t + 1]):
                    fail(f"decode {name}: T=1 row {t} differs from the T=7 row")
        valid = decode_valid_upto(small_lens, 7)
        big = fd.flash_decode_stacked(q, k, v, 1, valid)
        # BUDGET + 64, and the main path's draft capacity BUDGET + S - P
        for cap in (1088, BUDGET + S - P):
            small = fd.flash_decode_stacked(q, k[:, :, :cap].contiguous(),
                                            v[:, :, :cap].contiguous(), 1,
                                            valid)
            if not torch.equal(big, small):
                fail(f"decode {name}: capacity {cap} and {S} give different "
                     f"bits")
    main_err = max(e for k_, e in errs.items() if k_.startswith("bfloat16"))
    line(phase="decode_vs_plain", D=D, max_abs_err=errs,
         max_err_over_limit=ratios, missed_tile_rejected=faults,
         rows_bitexact=True, capacity_bitexact=True)
    return main_err


def _stream_rows(torch, dev, lens_after, T, sink):
    """Bounds [B, T] of StreamingLLM draft rows: the sequences' lengths after
    the step, a window of at most BUDGET - sink slots behind each, the sink,
    each row causal up to its own slot."""
    lens = torch.tensor(lens_after, dtype=torch.int32, device=dev)
    hi = lens[:, None] - T + 1 + torch.arange(T, dtype=torch.int32,
                                              device=dev)[None, :]
    lo = torch.clamp(lens - (BUDGET - sink), min=sink)[:, None].expand_as(hi)
    return torch.clamp(hi, max=sink), lo.contiguous(), hi


def check_intervals(torch, dev, D=64):
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops.attention import decode_valid_upto

    S = DRAFT_SLOTS
    # row sets: the streaming draft (sink 16, windows of up to 1008 slots
    # behind lengths that sit between compactions or below the budget), and
    # a 128-slot sink (two full tiles) with gaps of up to 9 whole tiles
    row_sets = {"stream": (SINK, [1061, 500, 1088, 1087, 1050, 100, 900, 1030]),
                "wide_gap": (128, [1088, 1040, 900, 1088, 700, 1000, 1088, 300])}
    errs, ratios, faults = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for T in (1, 2):
            for scale, qs in Q_SCALES.items():
                q, k, v = _cache_inputs(torch, dev, dtype, S, T, seed=30 + T,
                                        q_scale=qs, D=D)
                for rows, (sink, lens) in row_sets.items():
                    a, lo, hi = _stream_rows(torch, dev, lens, T, sink)
                    if rows == "wide_gap":
                        lo = torch.clamp(hi - 384, min=sink)
                    kl, vl = k[1], v[1]
                    # the sink K rows the draft reads apart (here other rows)
                    k_sink = k[0, :, :sink].contiguous()
                    out = fd.flash_decode_intervals(q, kl, vl, a, lo, hi,
                                                    k_sink=k_sink)
                    what = f"{name}_T{T}_{scale}_{rows}"
                    ref, limit = fd.intervals_plain_f32_and_limit(
                        q, kl, vl, a, lo, hi, k_sink)
                    _check_out(torch, what, out, ref, limit, errs, ratios)
                    if dtype != torch.bfloat16:
                        continue
                    # planted faults: a kernel that misses the window's last
                    # (diagonal) tile of rows with long windows, or the sink
                    long_ = (hi - lo) > 256
                    cut = torch.where(long_, torch.maximum(lo, (hi - 1) // 64 * 64),
                                      hi)
                    planted = {"missed_window_tile": (a, cut),
                               "missed_sink": (torch.zeros_like(a), hi)}
                    for fault, (fa, fhi) in planted.items():
                        bad = fd.intervals_plain(q.float(), kl.float(), vl.float(),
                                                 fa, lo, fhi, k_sink.float()
                                                 ).to(dtype)
                        rejected = not _hold(bad, ref, limit)[2]
                        faults[f"{what}_{fault}"] = rejected
                        # required on peaked inputs; a 16-slot sink among
                        # ~1000 slots may weigh less than the rounding bound
                        required = scale == "peaked" and (
                            fault == "missed_window_tile" or sink == 128)
                        if required and not rejected:
                            fail(f"intervals {what}: the limit does not reject "
                                 f"the planted fault {fault}")
        # bit-exact: intervals reducing to [0, hi) against the stacked kernel
        q, k, v = _cache_inputs(torch, dev, dtype, 4224, 7, seed=12, D=D)
        lens = torch.tensor([1000, 1081, 0, 511, 512, 7, 1024, 64],
                            dtype=torch.int32, device=dev)
        valid = decode_valid_upto(lens, 7)
        full = fd.flash_decode_stacked(q, k, v, 1, valid)
        for cap in (S, 4224):
            kc, vc = k[1, :, :cap].contiguous(), v[1, :, :cap].contiguous()
            for t0, T in ((0, 2), (2, 1), (5, 2)):
                hi = valid[:, t0:t0 + T].contiguous()
                out = fd.flash_decode_intervals(
                    q[:, t0:t0 + T].contiguous(), kc, vc,
                    torch.clamp(hi, max=SINK), torch.full_like(hi, SINK), hi,
                    k_sink=kc[:, :SINK].contiguous())
                if not torch.equal(out, full[:, t0:t0 + T]):
                    fail(f"intervals {name}: rows {t0}..{t0 + T - 1} on a "
                         f"{cap}-slot cache differ from flash_decode_stacked")
    main_err = max(e for k_, e in errs.items() if k_.startswith("bfloat16"))
    line(phase="intervals_vs_plain", D=D, S=S, max_abs_err=errs,
         max_err_over_limit=ratios, planted_fault_rejected=faults,
         bitexact_with_stacked=True)
    return main_err


def _quest_rows(torch, dev, T, seed, top_share=0.7, L=2):
    """A Quest draft's colmask [L, B, 1, QUEST_R] (top bits set with
    probability top_share, tail bits 1) and bounds [B, T]: row t attends the
    top region's bits and tail columns [NS, NS + tail + t + 1), ragged
    tails up to the full tail region."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cm = (torch.rand((L, B, 1, QUEST_R), generator=g, device=dev)
          < top_share).to(torch.int32)
    cm[..., QUEST_NS:] = 1
    tail = torch.tensor([128, 184, 3, 150, QUEST_WCAP - T, 129, 60, 170],
                        dtype=torch.int32, device=dev)
    hi = QUEST_NS + tail[:, None] + torch.arange(1, T + 1, dtype=torch.int32,
                                                 device=dev)
    return cm, torch.full_like(hi, QUEST_NS), hi


def check_masked(torch, dev, D=64):
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops.attention import decode_valid_upto

    errs, ratios, faults = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for T in (1, 2):
            cm, ns, hi = _quest_rows(torch, dev, T, seed=40 + T)
            ones = torch.ones_like(cm)
            for scale, qs in Q_SCALES.items():
                q, k, v = _cache_inputs(torch, dev, dtype, QUEST_R, T,
                                        seed=50 + T, q_scale=qs, D=D)
                for layer in (0, 1):
                    what = f"{name}_T{T}_{scale}_l{layer}"
                    ref, limit = fd.stacked_masked_plain_f32_and_limit(
                        q, k, v, layer, cm, ns, ns, hi)
                    out = fd.flash_decode_stacked_masked(q, k, v, layer, cm,
                                                         ns, ns, hi)
                    _check_out(torch, what, out, ref, limit, errs, ratios)
                    # planted fault: the kernel blind to the bits
                    blind = fd.flash_decode_stacked_masked(q, k, v, layer,
                                                           ones, ns, ns, hi)
                    faults[what] = not _hold(blind, ref, limit)[2]
                    if not faults[what]:
                        fail(f"masked {what}: the limit does not reject the "
                             f"kernel run with an all-ones colmask")
        # one kernel: all-ones bits and a = lo = 0 give the stacked bits
        q, k, v = _cache_inputs(torch, dev, dtype, QUEST_R, 7, seed=13, D=D)
        valid = decode_valid_upto(torch.tensor(
            [1000, 1081, 0, 511, 512, 7, 1024, 64], dtype=torch.int32,
            device=dev), 7)
        zero = torch.zeros_like(valid)
        ones = torch.ones((2, B, 1, QUEST_R), dtype=torch.int32, device=dev)
        for layer in (0, 1):
            if not torch.equal(
                    fd.flash_decode_stacked_masked(q, k, v, layer, ones, zero,
                                                   zero, valid),
                    fd.flash_decode_stacked(q, k, v, layer, valid)):
                fail(f"masked {name}: all-ones bits with a = lo = 0 differ "
                     f"from flash_decode_stacked")
    main_err = max(e for k_, e in errs.items() if k_.startswith("bfloat16"))
    line(phase="masked_vs_plain", D=D, R=QUEST_R, NS=QUEST_NS,
         max_abs_err=errs,
         max_err_over_limit=ratios, all_ones_colmask_rejected=faults,
         bitexact_with_stacked=True)
    return main_err


# every gather destination holds this byte before a bit check: a NaN in bf16
# and f32, never the right answer, so a chunk the kernel skips shows
SENTINEL = 0xFF


def _sentinel(torch, t):
    t.view(torch.uint8).fill_(SENTINEL)
    return t


def _untouched(torch, t):
    return bool((t.view(torch.uint8) == SENTINEL).all())


def _same(torch, got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _from_sentinel_blocks(torch, like, call):
    """call() (a gather without out, which allocates one output like each
    tensor of `like`, in order) right after sentinel-filled blocks of those
    sizes were freed: the caching allocator hands the same blocks back, so
    the outputs start as sentinel bytes. Returns (call's outputs as a list,
    whether they are those blocks); where they are not, the caller's launch
    into sentinel-filled tensors of the same shapes still checks the
    kernel."""
    blocks = [_sentinel(torch, torch.empty_like(t)) for t in like]
    ptrs = [t.data_ptr() for t in blocks]
    del blocks
    res = call()
    res = list(res) if isinstance(res, (tuple, list)) else [res]
    return res, [t.data_ptr() for t in res] == ptrs


def _gather_pages(torch, dev, n_src, n, seed):
    """[B, n] int32 page indices into n_src pages: random, one row out of
    order, one repeated, the last page and two past it, one below 0 (the
    kernel clamps into [0, n_src))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = torch.randint(0, n_src, (B, n), generator=g, device=dev,
                          dtype=torch.int32)
    pages[0] = torch.arange(n_src - 1, n_src - 1 - n, -1, device=dev)
    pages[1] = 5
    pages[2, :3] = torch.tensor([n_src - 1, n_src, n_src + 40], device=dev)
    pages[3, 0] = -3
    return pages


def check_page_gather(torch, dev):
    """page_gather bit-exact against its plain version at both head dims, in
    bf16 and f32, with pages of 128 rows (the Quest page) and of 66 rows
    (no multiple of the kernel's 16 KB chunk at either head dim or type):
    into new tensors and into a round buffer's top region, every
    destination sentinel-filled first; the kernel with its planted fault
    (each unit's last chunk dropped) must fail the same checks, and the C
    entry must refuse a ring beyond its limits (it alone holds them)."""
    from magicdec_tpu_torch.ops import page_gather as pg

    S, n = 4224, QUEST_NS // QUEST_PAGE
    res, reused, errs = {}, {}, {}
    for D in HEAD_DIMS:
        for page in (QUEST_PAGE, 66):
            pages = _gather_pages(torch, dev, S // page, n, seed=60 + page)
            top = n * page
            for dtype in (torch.bfloat16, torch.float32):
                name = f"D{D}_page{page}_{str(dtype).split('.')[1]}"
                _, k, v = _cache_inputs(torch, dev, dtype, S, 1, seed=61, D=D)
                bufs = torch.empty((2, 2, B, top + 64, k.shape[-1]),
                                   dtype=dtype, device=dev)
                for layer in (0, 1):
                    want = pg.page_gather_plain(k, v, layer, pages, page)
                    got, reused[f"{name}_l{layer}"] = _from_sentinel_blocks(
                        torch, want, lambda: pg.page_gather(k, v, layer, pages,
                                                            page))
                    fresh = [_sentinel(torch, torch.empty_like(w))
                             for w in want]
                    pg._gather_launch(k, v, layer, pages, page, fresh)
                    _sentinel(torch, bufs)
                    tops = [buf[layer, :, :top].view(B, n, page, -1)
                            for buf in bufs]
                    pg.page_gather(k, v, layer, pages, page, out=tops)
                    ok = (_same(torch, got, want) and _same(torch, fresh, want)
                          and _same(torch, tops, want)
                          and _untouched(torch, bufs[:, layer, :, top:])
                          and _untouched(torch, bufs[:, 1 - layer]))
                    if not ok:
                        fail(f"page_gather {name} layer {layer}: not "
                             f"bit-exact")
                    _sentinel(torch, bufs)
                    pg._gather_launch(k, v, layer, pages, page, tops, fault=1)
                    for t in fresh:
                        _sentinel(torch, t)
                    pg._gather_launch(k, v, layer, pages, page, fresh, fault=1)
                    if _same(torch, tops, want) or _same(torch, fresh, want):
                        fail(f"page_gather {name} layer {layer}: the bit "
                             f"check does not reject the dropped last chunk")
                    res[f"{name}_l{layer}"] = True
        errs["page_gather" + _sfx(D)] = 0.0
    for knobs in (dict(stages=1), dict(chunk_bytes=64 << 10, stages=4)):
        try:
            pg._gather_launch(k, v, 0, pages, page, tops, **knobs)
        except RuntimeError:
            continue
        fail(f"page_gather: the C entry took a ring of {knobs}")
    line(phase="page_gather_vs_plain", pages=[B, n], pages_rows=[QUEST_PAGE, 66],
         S=S, head_dims=list(HEAD_DIMS), bitexact=res,
         sentinel=f"0x{SENTINEL:02X} bytes", dropped_chunk_rejected=True,
         ring_beyond_limits_refused=True,
         new_tensors_from_sentinel_blocks=reused)
    return errs


def check_page_gather_single(torch, dev):
    """page_gather_single bit-exact against its plain version at both head
    dims, in bf16 and f32, with clusters of 2cap = 64 rows (the main path's
    store) and of 66 rows (halves of 33 rows, no multiple of a chunk): whole pages
    into a new tensor and halves into a round buffer's K and V top regions,
    every destination sentinel-filled first; the planted fault must fail
    the same checks."""
    from magicdec_tpu_torch.ops import page_gather as pg

    res, reused, errs = {}, {}, {}
    for D in HEAD_DIMS:
        for page in (2 * RETRO_CAP, 66):
            cap = page // 2
            pages = _gather_pages(torch, dev, RETRO_C, RETRO_N, seed=62 + page)
            top = RETRO_N * cap
            for dtype in (torch.bfloat16, torch.float32):
                name = f"D{D}_page{page}_{str(dtype).split('.')[1]}"
                _, store, _ = _cache_inputs(torch, dev, dtype, RETRO_C * page,
                                            1, seed=63, D=D)
                bufs = torch.empty((2, 2, B, top + 64, store.shape[-1]),
                                   dtype=dtype, device=dev)
                for layer in (0, 1):
                    want = pg.page_gather_single_plain(store, layer, pages,
                                                       page)
                    halves = (want[:, :, :cap], want[:, :, cap:])
                    (got,), reused[f"{name}_l{layer}"] = _from_sentinel_blocks(
                        torch, [want], lambda: pg.page_gather_single(
                            store, layer, pages, page))
                    fresh = _sentinel(torch, torch.empty_like(want))
                    pg._single_launch(store, layer, pages, page, (fresh,))
                    _sentinel(torch, bufs)
                    tops = [buf[layer, :, :top].view(B, RETRO_N, cap, -1)
                            for buf in bufs]
                    pg.page_gather_single(store, layer, pages, page, out=tops)
                    ok = (torch.equal(got, want) and torch.equal(fresh, want)
                          and _same(torch, tops, halves)
                          and _untouched(torch, bufs[:, layer, :, top:])
                          and _untouched(torch, bufs[:, 1 - layer]))
                    if not ok:
                        fail(f"page_gather_single {name} layer {layer}: not "
                             f"bit-exact")
                    _sentinel(torch, bufs)
                    pg._single_launch(store, layer, pages, page, tops, fault=1)
                    _sentinel(torch, fresh)
                    pg._single_launch(store, layer, pages, page, (fresh,),
                                      fault=1)
                    if _same(torch, tops, halves) or torch.equal(fresh, want):
                        fail(f"page_gather_single {name} layer {layer}: the "
                             f"bit check does not reject the dropped last "
                             f"chunk")
                    res[f"{name}_l{layer}"] = True
        errs["page_gather_single" + _sfx(D)] = 0.0
    line(phase="page_gather_single_vs_plain", pages=[B, RETRO_N],
         pages_rows=[2 * RETRO_CAP, 66], R=RETRO_C * 2 * RETRO_CAP,
         head_dims=list(HEAD_DIMS), bitexact=res,
         sentinel=f"0x{SENTINEL:02X} bytes", dropped_chunk_rejected=True,
         new_tensors_from_sentinel_blocks=reused)
    return errs


def check_centroid_scores(torch, dev):
    """centroid_scores against its plain version: both in f32 (the kernel
    converts q on load), sums in other orders and expf, so each score is
    held within 1e-5 + 1e-5 |plain|; each head's scores must sum to T*G.
    At the main path's C=130 and at C=1024 (P=32768), D 64 and 128; where
    scores_plan splits C, the limit must reject the scores with the last
    rank left out of the rows' (max, sum of exp) combine."""
    from magicdec_tpu_torch.ops import gemm_softmax as gs

    Hkv, G = 8, 4
    g = torch.Generator(device=dev).manual_seed(64)
    errs, ratios, faults, plans = {}, {}, {}, {}
    for D, C in ((64, RETRO_C), (128, RETRO_C), (64, 1024), (128, 1024)):
        plans[f"D{D}_C{C}"] = gs.scores_plan(C, D)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            for T in (1, 7):
                q = torch.randn((B, T, Hkv * G, D), generator=g,
                                device=dev).to(dtype)
                for scale, cs in (("flat", 0.2), ("peaked", 2.0)):
                    cent = torch.randn((B, C, Hkv * D), generator=g,
                                       device=dev) * cs
                    view = cent.view(B, C, Hkv, D).transpose(1, 2)
                    ref = gs.centroid_scores_plain(q, view)
                    out = gs.centroid_scores(q, view)
                    what = f"{name}_T{T}_D{D}_C{C}_{scale}"
                    limit = 1e-5 + 1e-5 * ref.abs()
                    _check_out(torch, what, out, ref, limit, errs, ratios)
                    if not torch.allclose(out.sum(-1), torch.full_like(
                            out[..., 0], T * G), rtol=1e-5, atol=1e-4):
                        fail(f"centroid_scores {what}: a head's mass is not "
                             f"T*G")
                    if gs.scores_plan(C, D)[0] > 1:
                        faulty = gs._scores_launch(q, view, fault=1)
                        faults[what] = not _hold(faulty, ref, limit)[2]
                        if not faults[what]:
                            fail(f"centroid_scores {what}: the limit does not "
                                 f"reject the scores with a rank left out")
    line(phase="centroid_scores_vs_plain", Hkv=Hkv, G=G, plans=plans,
         max_abs_err=errs, max_err_over_limit=ratios,
         rank_left_out_rejected=faults, tol="1e-5 + 1e-5|ref|")
    return max(e for k_, e in errs.items()
               if k_.startswith(f"bfloat16_T1_D64_C{RETRO_C}_"))


def check_prefill(torch, dev, D=64):
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops.attention import decode_valid_upto

    S, T = 4224, 128
    errs, ratios, faults = {}, {}, {}
    # (s_cap, per-sequence chunk starts): a first chunk, a partly filled
    # bucket (frontier 896 of 1024), ragged starts, the last chunk of P=4096
    cases = [(128, [0] * B), (1024, [768] * B),
             (2048, [1920, 1800, 0, 5, 1000, 1500, 1900, 128]),
             (4096, [P - T] * B)]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for scale, qs in Q_SCALES.items():
            q, k, v = _cache_inputs(torch, dev, dtype, S, T, seed=21,
                                    q_scale=qs, D=D)
            for cap, starts in cases:
                valid = decode_valid_upto(
                    torch.tensor(starts, dtype=torch.int32, device=dev), T)
                out = fd.flash_prefill(q, k, v, 1, valid, s_cap=cap)
                _check_case(torch, fd, f"{name}_{scale}_cap{cap}", out, q, k,
                            v, 1, valid, cap, scale, errs, ratios, faults)
                if (dtype == torch.bfloat16 and scale == "peaked"
                        and cap >= 1024):
                    _pipeline_fault(torch, fd, f"{name}_cap{cap}", q, k, v,
                                    1, valid, cap, faults, prefill=True)
    main_err = max(e for k_, e in errs.items() if k_.startswith("bfloat16"))
    line(phase="prefill_vs_plain", D=D, max_abs_err=errs,
         max_err_over_limit=ratios, missed_tile_rejected=faults)
    return main_err


# the weight products (name, K, N) of llama-3.2-1b (the main path) and of
# llama-3.1-8b (the head_dim-128 path)
GEMM_SHAPES = (("wqkv", 2048, 3072), ("wo", 2048, 2048),
               ("w_gate_up", 2048, 16384), ("w_down", 8192, 2048))
GEMM_SHAPES_8B = (("wqkv", 4096, 6144), ("wo", 4096, 4096),
                  ("w_gate_up", 4096, 28672), ("w_down", 14336, 4096))
GEMM_MODELS = {"1b": GEMM_SHAPES, "8b": GEMM_SHAPES_8B}
# int4_matmul's row counts: an AR step's 8 rows unpadded, a verify's 56, the
# model's padded decode rows (llama.row_bucket: 64 at B <= 2, 256 at B=8, 512
# at B=16) and a 1024-row prefill chunk
INT4_ROWS = (8, 56, 64, 256, 512, 1024)
INT4_CHECK_ROWS = (8, 56, 64, 256, 1024)


def check_int4(torch, dev):
    """int4_matmul against its plain version at both models' four product
    shapes, M in INT4_CHECK_ROWS, bf16 and f32 x, within
    int4_matmul_plain_f32_and_limit's per-element limit (f32 sums in
    another order; one bf16 rounding of the output); rows at M=8 bit-equal
    to the same rows inside M = 56, 256 and 1024; and, at M=1024, the limit
    rejects the output with one group's -8 rowsum correction left out and
    the output with the last K split's partial (of im.launch_plan) left
    out."""
    from magicdec_tpu_torch.ops import int4_matmul as im

    g = torch.Generator(device=dev).manual_seed(80)
    errs, ratios, faults, bits, splits = {}, {}, {}, {}, {}
    for model, shapes in GEMM_MODELS.items():
        for name, K, N in shapes:
            q4, s4 = im.pack_int4_cols(
                torch.randn((K, N), generator=g, device=dev) * 0.02)
            plan = im.launch_plan(K, N // 2)
            splits[f"{model}_{name}"] = len(plan)
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                x = torch.randn((max(INT4_CHECK_ROWS), K), generator=g,
                                device=dev).to(dtype)
                first = im.int4_matmul(x[:8], q4, s4)
                for M in INT4_CHECK_ROWS:
                    what = f"{model}_{name}_{dn}_M{M}"
                    out = im.int4_matmul(x[:M], q4, s4)
                    ref, limit = im.int4_matmul_plain_f32_and_limit(
                        x[:M], q4, s4)
                    _check_out(torch, what, out, ref, limit, errs, ratios)
                    if M in (56, 256, 1024):
                        bits[what] = torch.equal(first, out[:8])
                        if not bits[what]:
                            fail(f"int4 {what}: rows at M=8 differ from the "
                                 f"same rows inside M={M}")
                k0, k1 = plan[-1]
                for fault, faulty in (
                        ("correction", out.float() + 8.0 * x[:, :128].float(
                        ).sum(1, keepdim=True) * s4[0]),
                        ("split", out.float() - im.int4_matmul_plain(
                            x[:, k0:k1].float(), q4[k0:k1],
                            s4[k0 // 128:k1 // 128]))):
                    key = f"{model}_{name}_{dn}_{fault}"
                    faults[key] = not _hold(faulty, ref, limit)[2]
                    if not faults[key]:
                        fail(f"int4 {key}: the limit does not reject the "
                             f"output with the fault")
                del x, ref, limit, out, faulty, first
                torch.cuda.empty_cache()
    line(phase="int4_vs_plain", splits=splits, max_abs_err=errs,
         max_err_over_limit=ratios, rows_bitexact=bits,
         faults_rejected=faults)
    return max(e for k_, e in errs.items()
               if k_.startswith("1b") and "bfloat16_M256" in k_)


# the fused block's widths (D, HqD, I, O = the qkv width) at llama-3.2-1b
# (the main path) and llama-3.1-8b
FUSED_WIDTHS = {"1b": (2048, 2048, 8192, 3072), "8b": (4096, 4096, 14336, 6144)}


def check_fused(torch, dev):
    """fused_qkv (with and without a bias) and fused_post_attn against their
    plain versions at llama-3.2-1b's widths (bf16 and f32) and llama-3.1-8b's
    (bf16), M in {8, 56}: every element within fused_*_plain_f32_and_limit's
    limit and the mean error within MEAN_LIMIT of the mean |plain|; rows at
    M=8 bit-equal to the same rows inside M=56; and in bf16 the limits
    reject fused_qkv and fused_post_attn launched with their planted fault
    (the last K split's partial left out of each split product's sum)."""
    from magicdec_tpu_torch.ops import fused_block as fb

    g = torch.Generator(device=dev).manual_seed(81)
    errs, ratios, means, bits, faults = {}, {}, {}, {}, {}

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=g, device=dev) * s

    for model, (D, HqD, I, O) in FUSED_WIDTHS.items():
        dtypes = (torch.bfloat16, torch.float32) if model == "1b" else (
            torch.bfloat16,)
        for dtype in dtypes:
            dn = str(dtype).split(".")[1]
            x, ctx = rnd(56, D).to(dtype), rnd(56, HqD).to(dtype)
            n1 = (1.0 + rnd(D, s=0.1)).to(dtype)
            n2 = (1.0 + rnd(D, s=0.1)).to(dtype)
            wqkv, b = rnd(D, O, s=0.02).to(dtype), rnd(O, s=0.1).to(dtype)
            wo, wd = rnd(HqD, D, s=0.02).to(dtype), rnd(I, D, s=0.02).to(dtype)
            gu = rnd(D, 2, I, s=0.02).to(dtype)
            for M in (8, 56):
                post_ref = fb.fused_post_attn_plain_f32_and_limit(
                    x[:M], ctx[:M], wo, n2, gu, wd)
                cases = {
                    "qkv": (fb.fused_qkv(x[:M], n1, wqkv),
                            fb.fused_qkv_plain_f32_and_limit(x[:M], n1, wqkv)),
                    "qkv_bias": (fb.fused_qkv(x[:M], n1, wqkv, b),
                                 fb.fused_qkv_plain_f32_and_limit(
                                     x[:M], n1, wqkv, b)),
                    "post_attn": (fb.fused_post_attn(x[:M], ctx[:M], wo, n2,
                                                     gu, wd), post_ref)}
                for case, (out, (ref, limit)) in cases.items():
                    what = f"{model}_{case}_{dn}_M{M}"
                    _check_out(torch, what, out, ref, limit, errs, ratios)
                    means[what] = float((out.float() - ref).abs().mean()
                                        / ref.abs().mean())
                    if means[what] > fb.MEAN_LIMIT:
                        fail(f"fused {what}: mean error {means[what]} of the "
                             f"mean |plain| exceeds {fb.MEAN_LIMIT}")
                if dtype == torch.bfloat16:
                    for case, faulty, (ref, limit) in (
                            ("qkv_bias", fb._qkv_launch(x[:M], n1, wqkv, b,
                                                        fault=1)[0],
                             cases["qkv_bias"][1]),
                            ("post_attn", fb._post_attn_launch(
                                x[:M], ctx[:M], wo, n2, gu, wd, fault=1)[0],
                             post_ref)):
                        what = f"{model}_{case}_M{M}_split_left_out"
                        faults[what] = not _hold(faulty, ref, limit)[2]
                        if not faults[what]:
                            fail(f"fused {what}: the limit does not reject "
                                 f"the output with the last split left out")
            key = f"{model}_{dn}"
            bits[key] = (torch.equal(fb.fused_qkv(x[:8], n1, wqkv, b),
                                     fb.fused_qkv(x, n1, wqkv, b)[:8])
                         and torch.equal(fb.fused_post_attn(x[:8], ctx[:8], wo,
                                                            n2, gu, wd),
                                         fb.fused_post_attn(x, ctx, wo, n2, gu,
                                                            wd)[:8]))
            if not bits[key]:
                fail(f"fused {key}: rows at M=8 differ from the same rows "
                     f"inside M=56")
            del x, ctx, wqkv, wo, wd, gu, cases, post_ref
            torch.cuda.empty_cache()
    plans = {f"{model}_{name}": len(fb.launch_plan(K, N))
             for model, (D, HqD, I, O) in FUSED_WIDTHS.items()
             for name, K, N in (("wo", HqD, D), ("w_gate_up", D, 2 * I),
                                ("w_down", I, D))}
    plans.update({f"{model}_wqkv": len(fb.qkv_plan(D, O))
                  for model, (D, _, _, O) in FUSED_WIDTHS.items()})
    line(phase="fused_vs_plain", splits=plans, max_abs_err=errs,
         max_err_over_limit=ratios, mean_err_over_mean=means,
         mean_limit=fb.MEAN_LIMIT, rows_bitexact=bits, faults_rejected=faults)
    return {"fused_qkv": errs["1b_qkv_bfloat16_M8"],
            "fused_post_attn": errs["1b_post_attn_bfloat16_M8"]}


def _hold_lse(torch, fd, what, got, want, ctx_ref, ctx_limit, dtype, errs,
              ratios):
    """One return_lse output (ctx, m, l) against the plain f32 version: ctx
    of the live rows within the ctx limit, m of the live rows and l of all
    rows within fd.lse_limits, an empty row (plain l == 0) with l == 0 and
    ctx == 0, every output finite. Records ctx's max abs error (and the
    worst error / limit of each output)."""
    ctx, m, l = got
    _, m_ref, l_ref = want
    live = l_ref > 0
    lim_m, lim_l = fd.lse_limits(m_ref, l_ref, dtype)
    if not all(bool(torch.isfinite(t.float()).all()) for t in got):
        fail(f"lse {what}: non-finite output")
    diff = (ctx.float() - ctx_ref).abs()[live]
    dm = (m - m_ref).abs()[live]
    dl = (l - l_ref).abs()
    errs[what] = float(diff.max())
    ratios[what] = {"ctx": float((diff / ctx_limit[live]).max()),
                    "m": float((dm / lim_m[live]).max()),
                    "l": float((dl / lim_l).max())}
    if max(ratios[what].values()) > 1.0:
        fail(f"lse {what}: outside the limit ({ratios[what]} of it)")
    if not (bool((l[~live] == 0).all()) and bool((ctx[~live] == 0).all())):
        fail(f"lse {what}: an empty row gives l != 0 or ctx != 0")


def check_lse(torch, dev, D=64):
    """The return_lse forms against their plain versions at the GliDe
    shapes, bf16 and f32, flat and peaked softmax: flash_decode_stacked over
    a 4224-slot stacked cache with ragged prefixes at T=7 (tree (2,2)'s
    verify) and T=29 (tree (4,2,2)'s: attention_impls.flash_stacked_lse,
    two launches), each with one empty row; flash_decode_intervals over a
    4224-slot flat own cache's prefix [0, base) at T in {1, 2, 4, 8, 16}
    (the tree drafts' levels; 16 is tree (4,2,2)'s leaf level, 64 rows),
    one sequence with an empty prefix. ctx within plain_f32_and_limit, m
    and l within fd.lse_limits; ctx bit-equal with and without the flag
    (T=29 chunk by chunk); a planted fault (l of a merge that skips each
    row's last split of fd.split_slots() slots) must fail the l limit; merge_lse of the
    kernel over two disjoint halves of the prefix must hold the one-pass
    attention over their union within twice its limit (each half's ctx is
    rounded to the cache dtype before the merge rounds once more)."""
    from magicdec_tpu_torch.engine.attention_impls import flash_stacked_lse
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops.attention import merge_lse

    S = 4224
    lens = torch.tensor([4100, 4160, 3, 511, 512, 2049, 4096, 1000],
                        dtype=torch.int32, device=dev)
    bases = torch.tensor([4128, 0, 700, 513, 1024, 2049, 4000, 64],
                         dtype=torch.int32, device=dev)
    errs, ratios, faults, merged = {}, {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        for scale, qs in Q_SCALES.items():
            for T in (7, 29):
                q, k, v = _cache_inputs(torch, dev, dtype, S, T, seed=90 + T,
                                        q_scale=qs, D=D)
                hi = lens[:, None].expand(B, T).contiguous()
                hi[2, 0] = 0                              # an empty row
                what = f"stacked_{name}_T{T}_{scale}"
                got = flash_stacked_lse(q, k, v, 1, hi)
                step = 64 // 4
                plain_ctx = torch.cat([fd.flash_decode_stacked(
                    q[:, i:i + step].contiguous(), k, v, 1,
                    hi[:, i:i + step].contiguous()) for i in range(0, T, step)],
                    dim=1)
                if not torch.equal(got[0], plain_ctx):
                    fail(f"lse {what}: ctx differs from the call without "
                         f"return_lse")
                want = fd.attention_plain_lse(q.float(), k.float(), v.float(),
                                              1, hi)
                ref, limit = fd.plain_f32_and_limit(q, k, v, 1, hi)
                _hold_lse(torch, fd, what, got, want, ref, limit, dtype, errs,
                          ratios)
                # planted fault: l without each long row's last split
                split = fd.split_slots()
                cut = torch.where(hi > split, (hi - 1) // split * split, hi)
                _, _, l_bad = fd.attention_plain_lse(
                    q.float(), k.float(), v.float(), 1, cut.to(torch.int32))
                _, lim_l = fd.lse_limits(want[1], want[2], dtype)
                faults[what] = bool(((l_bad - want[2]).abs() > lim_l).any())
                if not faults[what]:
                    fail(f"lse {what}: the l limit does not reject a merge "
                         f"that skips the last split")
            for T in (1, 2, 4, 8, 16):
                q, k, v = _cache_inputs(torch, dev, dtype, S, T, seed=95 + T,
                                        q_scale=qs, L=1, D=D)
                kl, vl = k[0], v[0]
                zero = torch.zeros((B, T), dtype=torch.int32, device=dev)
                hi = bases[:, None].expand(B, T).contiguous()
                what = f"intervals_{name}_T{T}_{scale}"
                got = fd.flash_decode_intervals(q, kl, vl, zero, zero, hi,
                                                return_lse=True)
                if not torch.equal(got[0], fd.flash_decode_intervals(
                        q, kl, vl, zero, zero, hi)):
                    fail(f"lse {what}: ctx differs from the call without "
                         f"return_lse")
                want = fd.intervals_plain_lse(q.float(), kl.float(),
                                              vl.float(), zero, zero, hi)
                ref, limit = fd.intervals_plain_f32_and_limit(q, kl, vl, zero,
                                                              zero, hi)
                _hold_lse(torch, fd, what, got, want, ref, limit, dtype, errs,
                          ratios)
                # two disjoint halves [0, h) and [h, base), merged
                h = (hi // 2 + 37).clamp(max=hi)
                a = fd.flash_decode_intervals(q, kl, vl, zero, zero, h,
                                              return_lse=True)
                b = fd.flash_decode_intervals(q, kl, vl, zero, h, hi,
                                              return_lse=True)
                out = merge_lse(*a, *b)
                live = want[2] > 0
                diff = (out.float() - ref).abs()[live]
                merged[what] = float((diff / (2 * limit[live])).max())
                if merged[what] > 1.0:
                    fail(f"lse {what}: merge_lse of two halves is "
                         f"{merged[what]} times twice the one-pass limit")
    line(phase="lse_vs_plain", D=D, S=S, max_abs_err=errs,
         max_err_over_limit=ratios, skipped_split_rejected=faults,
         merge_of_halves_over_twice_limit=merged,
         limits={"ctx": "plain_f32_and_limit",
                 "m": "1e-5 (1 + |m|) where l > 0",
                 "l": "2^-8 l + 1e-5 (bf16), 2e-5 + 2e-5 l (f32)"},
         ctx_bitexact_with_and_without_flag=True)
    return (max(e for k_, e in errs.items()
                if k_.startswith("stacked_bfloat16")),
            max(e for k_, e in errs.items()
                if k_.startswith("intervals_bfloat16")))


# ---------------------------------------------------------------------------
# phase 9: the card's path against the CPU plain path on a small model, and
# Quest and RetroInfer on that model
# ---------------------------------------------------------------------------

def _small_cfg():
    """The small f32 model of phase 9: llama-3.2-1b's head_dim of 64 (the
    kernels' build) at 2 layers, dim 256 and 4/2 heads."""
    from magicdec_tpu_torch.models.config import ModelArgs
    return ModelArgs.from_name("llama-3.2-1b").replace(
        n_layer=2, dim=256, n_head=4, n_kv_head=2, intermediate_size=512,
        vocab_size=1024)


def _to(tree, d):
    """A params tree, plain or with quantized leaves, on device d (or, a
    plain tree, cast to dtype d)."""
    from magicdec_tpu_torch.quant.int8 import Int4ColWeight
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, Int4ColWeight):
        return Int4ColWeight(tree.q4.to(d), tree.s4.to(d), tree.out_shape)
    return tree.to(d)


def check_reference(torch, dev):
    """The small f32 model's logits (a 128-token prefill chunk, then a
    7-token step) on the card's path against the CPU plain path: plain
    weights unfused (fused=False; "auto" would run the step fused on the
    card), int8 and int4 weights (quantize_params), and plain weights with
    fused=True (the fused block for both forwards)."""
    from magicdec_tpu_torch.engine import attention_impls as impls
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.quant.int8 import quantize_params

    cfg = _small_cfg()
    params = llama.init_params(cfg, torch.float32, scale=0.1, seed=1,
                               device="cpu")
    variants = {"plain": (params, False),
                "int8": (quantize_params(params, "int8"), None),
                "int4": (quantize_params(params, "int4"), None),
                "fused": (params, True)}
    tokens = torch.randint(0, cfg.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(2))
    errs = {}
    for name, (tree, fused) in variants.items():
        logits = {}
        for d in ("cpu", dev):
            p = _to(tree, d)
            shape = (cfg.n_layer, 2, 256, cfg.n_kv_head * cfg.head_dim)
            caches = (torch.zeros(shape, device=d),
                      torch.zeros(shape, device=d))
            lens = torch.zeros(2, dtype=torch.int32, device=d)
            pre = llama.forward(p, cfg, tokens.to(d),
                                impls.target_attn(cfg, lens, 128, cap=128,
                                                  uniform_start=0), caches,
                                fused=fused)
            dec = llama.forward(p, cfg, tokens[:, :7].to(d),
                                impls.target_attn(cfg, lens + 128, 7), caches,
                                fused=fused)
            logits[str(d)] = (pre.cpu(), dec.cpu())
        cpu, gpu = logits["cpu"], logits[str(dev)]
        errs[name] = [float((a - b).abs().max()) for a, b in zip(cpu, gpu)]
    # f32 on both sides (TF32 off); different summation orders
    if not all(e < 1e-3 for v in errs.values() for e in v):
        fail(f"card path vs CPU plain path: max abs logits err {errs}")
    line(phase="reference_small_f32", prefill_decode_logits_err=errs,
         tol=1e-3)


def quest_small_f32(torch, dev):
    """Quest at full coverage on the small f32 model of check_reference, at
    the JAX package's test settings (tests/test_quest.py: B=2, P=512, 32 new
    tokens, gamma 3, budget P + 128): the draft reads every page, in another
    order than the verify, so acceptance is near 1.0, not exactly 1.0."""
    import numpy as np

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                                generate_selfspec)
    from magicdec_tpu_torch.models import llama

    cfg = _small_cfg()
    params = llama.init_params(cfg, torch.float32, scale=0.3, seed=1,
                               device=dev)
    Bs, Ps, new, gamma = 2, 512, 32, 3
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (Bs, Ps))
    kw = dict(batch_size=Bs, max_len=Ps + new + gamma + 16)
    ar, _ = generate_autoregressive(Engine(cfg, params, **kw), prompt, new)
    L = cfg.n_layer

    def go():
        eng = Engine(cfg, params, spec="quest", draft_budget=Ps + QUEST_PAGE,
                     latest_k=QUEST_TAIL, **kw)
        return generate_selfspec(eng, prompt, gamma, new)

    def expect(result):
        r = result[-1].rounds
        return dict(_zero(), flash_prefill=L * Ps // 128,
                    flash_decode_stacked=L * r, page_gather=L * r,
                    flash_decode_stacked_masked=L * gamma * r,
                    **_fused_pair(L * (gamma + 1) * r))

    (out, counts, stats), used, _ = _drive(torch, "quest_small_f32", go,
                                           expect)
    out, ar = out.cpu(), ar.cpu()
    for b in range(Bs):
        n = min(int(counts[b]), new)
        if not torch.equal(out[b, :n], ar[b, :n]):
            fail(f"quest_small_f32: sequence {b} differs from the AR stream")
    if stats.acceptance_rate < 0.9:
        fail(f"quest_small_f32: full-coverage acceptance "
             f"{stats.acceptance_rate} < 0.9")
    line(phase="quest_small_f32", B=Bs, P=Ps, new_tokens=new, gamma=gamma,
         budget=Ps + QUEST_PAGE, acceptance=stats.acceptance_rate,
         rounds=stats.rounds, launches=used, lossless=True)


def retro_small_f32(torch, dev):
    """RetroInfer on the fold path on the small f32 model of check_reference,
    at the JAX package's test settings (tests/test_retro.py
    test_retro_lossless_past_tail_window: B=2, P=512, 72 new tokens, gamma
    3, budget 256, latest_k 32, retro_cap 16, TAIL_COVERS_MAX lowered to 0):
    the tail compacts and the rows that age out of it are folded into the
    cluster index; the stream must equal the AR stream."""
    import numpy as np

    from magicdec_tpu_torch.engine import retro
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                                generate_selfspec)
    from magicdec_tpu_torch.models import llama

    cfg = _small_cfg()
    params = llama.init_params(cfg, torch.float32, scale=0.3, seed=1,
                               device=dev)
    Bs, Ps, new, gamma, cap = 2, 512, 72, 3, 16
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (Bs, Ps))
    kw = dict(batch_size=Bs, max_len=Ps + new + gamma + 16)
    ar, _ = generate_autoregressive(Engine(cfg, params, **kw), prompt, new)
    L = cfg.n_layer
    engines = []

    def go():
        eng = Engine(cfg, params, spec="retro", draft_budget=256, latest_k=32,
                     retro_cap=cap, **kw)
        engines.append(eng)
        return generate_selfspec(eng, prompt, gamma, new)

    def expect(result):
        r = result[-1].rounds
        return dict(_zero(), flash_prefill=L * Ps // 128,
                    flash_decode_stacked=L * r, page_gather_single=L * r,
                    centroid_scores=L * r,
                    flash_decode_stacked_masked=L * gamma * r,
                    **_fused_pair(L * (gamma + 1) * r))

    saved, retro.TAIL_COVERS_MAX = retro.TAIL_COVERS_MAX, 0
    try:
        (out, counts, stats), used, _ = _drive(torch, "retro_small_f32", go,
                                               expect)
    finally:
        retro.TAIL_COVERS_MAX = saved
    out, ar = out.cpu(), ar.cpu()
    for b in range(Bs):
        n = min(int(counts[b]), new)
        if n <= 32 or not torch.equal(out[b, :n], ar[b, :n]):
            fail(f"retro_small_f32: sequence {b} differs from the AR stream "
                 f"or stopped inside the tail window")
    if stats.compactions == 0:
        fail("retro_small_f32: the tail never compacted (no fold ran)")
    folded = int((engines[0].spec_index[1] >= Ps).sum())
    line(phase="retro_small_f32", B=Bs, P=Ps, new_tokens=new, gamma=gamma,
         budget=256, latest_k=32, retro_cap=cap,
         clusters=engines[0].retro_clusters, acceptance=stats.acceptance_rate,
         rounds=stats.rounds, compactions=stats.compactions,
         generated_rows_indexed=folded, index_build_s=stats.index_build_s,
         launches=used, lossless=True)


# ---------------------------------------------------------------------------
# phases 10-12: row-count numerics, the main path at llama-3.2-1b full width,
# two-model SD
# ---------------------------------------------------------------------------

# the per-shard forms of tensor parallelism: entry -> (module, form, the
# kernel entry each launch of the form is also counted on)
SHARDED = {
    "flash_decode_stacked_sharded": ("engine.attention_impls",
                                     "_flash_stacked", "flash_decode_stacked"),
    "flash_prefill_sharded": ("engine.attention_impls",
                              "_flash_prefill_dispatch", "flash_prefill"),
    "flash_decode_intervals_sharded": ("engine.attention_impls",
                                       "_flash_intervals",
                                       "flash_decode_intervals"),
    "flash_decode_stacked_masked_sharded": ("engine.retro", "_tail_attend",
                                            "flash_decode_stacked_masked"),
    "page_gather_sharded": ("ops.page_gather", "page_gather_sharded",
                            "page_gather"),
    "page_gather_single_sharded": ("ops.page_gather",
                                   "page_gather_single_sharded",
                                   "page_gather_single"),
    "centroid_scores_sharded": ("ops.gemm_softmax", "centroid_scores_sharded",
                                "centroid_scores"),
    "flash_decode_stacked_lse_sharded": ("engine.attention_impls",
                                         "flash_stacked_lse",
                                         "flash_decode_stacked_lse"),
}
KERNELS = ("flash_decode_stacked", "flash_decode_intervals",
           "flash_decode_stacked_masked", "page_gather", "flash_prefill",
           "page_gather_single", "centroid_scores", "int4_matmul",
           "fused_qkv", "fused_post_attn", "flash_decode_stacked_lse",
           "flash_decode_intervals_lse") + tuple(SHARDED)


def _counters():
    """Each kernel entry's (wrapper, count attribute): the return_lse forms
    (name + "_lse") are counted apart, on their wrapper's launches_lse; the
    per-shard forms on their own launches."""
    import importlib

    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops import fused_block as fb
    from magicdec_tpu_torch.ops import gemm_softmax as gs
    from magicdec_tpu_torch.ops import int4_matmul as im
    from magicdec_tpu_torch.ops import page_gather as pg
    module = {"page_gather": pg, "page_gather_single": pg,
              "centroid_scores": gs, "int4_matmul": im, "fused_qkv": fb,
              "fused_post_attn": fb}
    out = {}
    for name in KERNELS:
        if name in SHARDED:
            mod, form, _ = SHARDED[name]
            out[name] = (getattr(importlib.import_module(
                f"magicdec_tpu_torch.{mod}"), form), "launches")
            continue
        lse = name.endswith("_lse")
        base = name[:-len("_lse")] if lse else name
        out[name] = (getattr(module.get(base, fd), base),
                     "launches_lse" if lse else "launches")
    return out


def _counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def _set_counts(counts):
    for name, (fn, attr) in _counters().items():
        setattr(fn, attr, counts[name])


def _zero():
    return dict.fromkeys(KERNELS, 0)


def _add(a, b):
    return {k: a[k] + b[k] for k in a}


def _fused_pair(n):
    """The fused pair's launch counts for n layers of forwards on the fused
    route (the default: plain weights on the card, T <= 32, no tp mesh):
    fused_qkv and fused_post_attn once a layer each."""
    return dict(fused_qkv=n, fused_post_attn=n)


@contextlib.contextmanager
def _fused_mode(llama, mode):
    """llama.set_fused_mode(mode) within, the mode before it after."""
    saved = llama._FUSED_MODE
    llama.set_fused_mode(mode)
    try:
        yield
    finally:
        llama.set_fused_mode(saved)


# (batch, gamma) row cases of gemm_rows: the main path's, and the JAX
# package's benchmarks/production_shape.py defaults (:53, :56), whose verify
# (80 rows) pads to another bucket than its AR and draft steps (16 rows)
B16, B16_GAMMA, B16_P = 16, 4, 1024
ROW_CASES = ((B, GAMMA), (B16, B16_GAMMA))


def gemm_rows(torch, dev, L=16):
    """Why models/llama.py pads rows, and what it costs: for each row-wise
    product of a decode step at llama-3.2-1b widths and each (batch, gamma)
    of ROW_CASES, whether the AR/draft rows (M=batch) get the bits of the
    same rows inside a verify (M=batch*(gamma+1)) unpadded, padded each to
    a multiple of 64 (the port's padding before this check's B=16 case), and
    padded as the port pads (llama.row_bucket: one count fixed by the
    batch); and the ms of one product at the main path's row counts (16
    layers of weights cycled, so they are read from HBM as in a step).
    Fails if rows padded as the port pads differ: the invariants rest on
    them. On an H100 with cuBLAS of CUDA 12.8 the w_down rows differ
    unpadded at M=8 against 56, and padded to 64 against 128 at M=16
    against 80."""
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.ops.norms import rms_norm

    g = torch.Generator(device=dev).manual_seed(3)
    Mv = B * (GAMMA + 1)
    M_max = max(b * (gm + 1) for b, gm in ROW_CASES)
    pad = llama._pad_rows
    res, extra_ms = {}, 0.0

    def rows_equal(f, b, gm):
        m = b * (gm + 1)
        r_ar, r_v = llama.row_bucket(b, 1), llama.row_bucket(b, gm + 1)
        return {"M": [b, m], "M_pad64": [pad(x[:b]).shape[0],
                                         pad(x[:m]).shape[0]],
                "M_padded": [r_ar, r_v],
                "unpadded_rows_equal": torch.equal(f(x[:b]), f(x[:m])[:b]),
                "pad64_rows_equal": torch.equal(f(pad(x[:b]))[:b],
                                                f(pad(x[:m]))[:b]),
                "padded_rows_equal": torch.equal(f(pad(x[:b], r_ar))[:b],
                                                 f(pad(x[:m], r_v))[:b])}

    rows = llama.row_bucket(B, 1)
    for name, K, N in (("wqkv", 2048, 3072), ("wo", 2048, 2048),
                       ("w_gate_up", 2048, 16384), ("w_down", 8192, 2048),
                       ("unembed", 2048, 128256)):
        n_w = 1 if name == "unembed" else L
        w = (torch.randn((n_w, K, N), generator=g, device=dev) * 0.02).to(
            torch.bfloat16)
        x = torch.randn((M_max, K), generator=g, device=dev,
                        dtype=torch.bfloat16)
        if name == "unembed":
            def mm(a, i):
                return torch.mm(a, w[i], out_dtype=torch.float32)
        else:
            def mm(a, i):
                return a @ w[i]
        res[name] = {f"B{b}_gamma{gm}": rows_equal(lambda a: mm(a, 0), b, gm)
                     for b, gm in ROW_CASES}
        res[name].update({
            "ms_unpadded_M8": _time_ms(torch, lambda i: mm(x[:B], i), n_w),
            "ms_unpadded_M56": _time_ms(torch, lambda i: mm(x[:Mv], i), n_w),
            "ms_padded_M64": _time_ms(torch, lambda i: mm(pad(x[:B]), i), n_w),
            f"ms_padded_M{rows}": _time_ms(
                torch, lambda i: mm(pad(x[:B], rows), i), n_w)})
        per_step = 1 if name == "unembed" else L
        extra_ms += per_step * (res[name][f"ms_padded_M{rows}"]
                                - res[name]["ms_unpadded_M8"])
        del w
    x = torch.randn((M_max, 2048), generator=g, device=dev,
                    dtype=torch.bfloat16)
    w = torch.ones(2048, device=dev, dtype=torch.bfloat16)
    res["rms_norm"] = {f"B{b}_gamma{gm}": rows_equal(lambda a: rms_norm(a, w),
                                                     b, gm)
                       for b, gm in ROW_CASES}
    line(phase="gemm_rows", row_cases=ROW_CASES,
         decode_rows_per_seq=llama.DECODE_ROWS_PER_SEQ,
         padding_ms_per_ar_step=extra_ms, **res)
    bad = [f"{k} {case}" for k, r in res.items() for case, c in r.items()
           if isinstance(c, dict) and not c["padded_rows_equal"]]
    if bad:
        fail(f"padded rows differ across row counts in {bad}")


def main_inputs(torch, dev):
    """llama-3.2-1b's random bf16 weights (seed 0) and the prompts."""
    import numpy as np

    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("llama-3.2-1b")
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, seed=0,
                               device=dev)
    torch.cuda.synchronize()
    line(phase="init", model="llama-3.2-1b", seconds=time.perf_counter() - t0)
    return params, np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P))


def _drive(torch, name, fn, expect):
    """Zero every kernel's launch count, run fn, read the counts and hold
    them to expect(result); returns (result, counts, seconds)."""
    _set_counts(_zero())
    t = time.perf_counter()
    result = fn()
    seconds = time.perf_counter() - t
    used = _counts()
    want = expect(result)
    if used != want:
        fail(f"{name}: kernel launches {used}, the path implies {want}")
    torch.cuda.empty_cache()
    return result, used, seconds


def _check_stream(torch, name, out, counts, ar, vocab, new=NEW):
    """Invariant 1: the emitted tokens are the AR stream (of `new`
    tokens)."""
    out = torch.as_tensor(out).cpu()
    ar = torch.as_tensor(ar)
    if out.min() < 0 or out.max() >= vocab:
        fail(f"{name}: token ids out of range")
    for b in range(out.shape[0]):
        n = min(int(counts[b]), new)
        if n <= 0 or not torch.equal(out[b, :n], ar[b, :n]):
            fail(f"{name}: stream of sequence {b} differs from the AR "
                 f"stream (invariant 1)")


def main_path(torch, dev, params, prompt):
    import numpy as np

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                                generate_selfspec)
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("llama-3.2-1b")
    L = cfg.n_layer
    runs, total = {}, _zero()

    def run(name, spec, budget):
        runs[name] = _spec_run(torch, cfg, params, prompt, name, spec, budget)
        total.update(_add(total, runs[name]["launches"]))

    run("ar", None, 0)
    run("snapkv", "snapkv", BUDGET)
    run("snapkv_full", "snapkv", P)
    run("streaming", "streaming", BUDGET)
    run("streaming_full", "streaming", STREAM_FULL)
    run("quest", "quest", BUDGET)
    run("quest_full", "quest", QUEST_FULL)
    run("retro", "retro", BUDGET)
    run("squeeze", "squeeze", BUDGET)

    # C1: the JAX package's production_shape.py batch and gamma (B=16,
    # gamma=4: a verify of 80 rows against AR and draft steps of 16) at full
    # width; P cut to B16_P, where budget B16_P is the full budget
    prompt16 = np.random.default_rng(8).integers(0, cfg.vocab_size,
                                                 (B16, B16_P))
    kw16 = dict(batch_size=B16, max_len=B16_P + NEW + 2 * B16_GAMMA + 16)

    def go16(spec):
        def go():
            if spec is None:
                out, stats = generate_autoregressive(
                    Engine(cfg, params, **kw16), prompt16, NEW)
                return out, torch.full((B16,), NEW, dtype=torch.int32), stats
            return generate_selfspec(
                Engine(cfg, params, spec="snapkv", draft_budget=B16_P,
                       window_size=WINDOW, **kw16), prompt16, B16_GAMMA, NEW)
        return go

    def expect16(spec):
        def launches(result):
            r = result[-1].rounds
            steps = NEW - 1 if spec is None else (B16_GAMMA + 1) * r
            return dict(_zero(), flash_prefill=L * B16_P // 128,
                        flash_decode_stacked=L * steps,
                        **_fused_pair(L * steps))
        return launches

    for name, spec in (("b16_ar", None), ("b16_snapkv_full", "snapkv")):
        (out, counts, stats), used, seconds = _drive(torch, name, go16(spec),
                                                     expect16(spec))
        runs[name] = dict(out=out.cpu(), counts=counts.cpu(), stats=stats,
                          total_s=seconds, launches=used)
        total.update(_add(total, used))
    _check_stream(torch, "b16_snapkv_full", runs["b16_snapkv_full"]["out"],
                  runs["b16_snapkv_full"]["counts"], runs["b16_ar"]["out"],
                  cfg.vocab_size)

    ar = runs["ar"]["out"]
    spec_runs = [k for k in runs if k not in ("ar", "b16_ar")]
    for name in spec_runs:
        if name != "b16_snapkv_full":
            _check_stream(torch, name, runs[name]["out"], runs[name]["counts"],
                          ar, cfg.vocab_size)
    for name in ("snapkv_full", "streaming_full", "b16_snapkv_full"):
        acc = runs[name]["stats"].acceptance_rate
        if acc != 1.0:
            fail(f"{name}: full-budget acceptance {acc} != 1.0 (invariant 2)")
    for name in ("streaming", "quest", "quest_full"):
        if runs[name]["stats"].compactions == 0:
            fail(f"{name}: the draft window never compacted")

    def rate(r):
        s = r["stats"]
        return s.generated_tokens / s.wall_time_s

    line(phase="main_path", model="llama-3.2-1b", dtype="bfloat16", B=B, P=P,
         new_tokens=NEW, gamma=GAMMA, budget=BUDGET, sink=SINK,
         streaming_draft_slots=DRAFT_SLOTS, streaming_full_budget=STREAM_FULL,
         quest_round_buffer=QUEST_R, quest_full_budget=QUEST_FULL,
         retro_clusters=[RETRO_C, RETRO_CAP], retro_gathered=RETRO_N,
         b16={"B": B16, "gamma": B16_GAMMA, "P": B16_P, "P_cut_from": P,
              "budget": B16_P, "note": f"P cut to {B16_P} to save time, so "
              f"the SnapKV budget {B16_P} is the full budget"},
         index_build_s={k: runs[k]["stats"].index_build_s
                        for k in ("retro", "squeeze")},
         tok_s={k: rate(r) for k, r in runs.items()},
         acceptance={k: runs[k]["stats"].acceptance_rate for k in spec_runs},
         rounds={k: runs[k]["stats"].rounds for k in spec_runs},
         compactions={k: runs[k]["stats"].compactions for k in spec_runs},
         run_s={k: r["total_s"] for k, r in runs.items()},
         decode_s={k: r["stats"].wall_time_s for k, r in runs.items()},
         launches={k: r["launches"] for k, r in runs.items()},
         invariant1=True, invariant2=True)
    return total, ar, {k: rate(runs[k]) for k in ("ar", "snapkv",
                                                  "snapkv_full")}


def _path_launches(L, spec, new=NEW, sharded=False):
    """The launch counts a B=8, P-token main-path run of `new` tokens
    implies (AR or self-speculation in mode spec), as a function of its
    result: every decode forward (new - 1 AR steps, or gamma draft steps
    and a verify a round) on the fused pair; sharded: a tp rank's run,
    whose every launch goes through a per-shard form too and whose
    forwards stay unfused."""
    def launches(result):
        r = result[-1].rounds
        steps = new - 1 if spec is None else (GAMMA + 1) * r
        decode = (L * steps if spec in (None, "snapkv") else L * r)
        draft = L * GAMMA * r
        clustered = spec in ("retro", "squeeze")
        out = dict(_zero(), flash_prefill=L * (P // 128),
                   flash_decode_stacked=decode,
                   flash_decode_intervals=draft * (spec == "streaming"),
                   flash_decode_stacked_masked=draft * (
                       spec == "quest" or clustered),
                   page_gather=L * r * (spec == "quest"),
                   page_gather_single=L * r * clustered,
                   centroid_scores=L * r * (spec == "retro"),
                   **_fused_pair(0 if sharded else L * steps))
        if sharded:
            out.update({k: out[base] for k, (_, _, base) in SHARDED.items()})
        return out
    return launches


def _spec_run(torch, cfg, params, prompt, name, spec, budget):
    """One main-path run (B, P, NEW, GAMMA) of the Engine: AR when spec is
    None, else generate_selfspec at the given draft budget; launch counts
    held to _path_launches. Returns out, counts, stats, seconds, launches."""
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                                generate_selfspec)

    def go():
        eng = Engine(cfg, params, batch_size=B, max_len=MAX_LEN, spec=spec,
                     draft_budget=budget, window_size=WINDOW, sink_size=SINK,
                     draft_headroom=STREAM_HEADROOM, latest_k=QUEST_TAIL,
                     quest_page=QUEST_PAGE, retro_cap=RETRO_CAP)
        if spec is None:
            out, stats = generate_autoregressive(eng, prompt, NEW)
            return out, torch.full((B,), NEW, dtype=torch.int32), stats
        return generate_selfspec(eng, prompt, GAMMA, NEW)

    (out, counts, stats), used, seconds = _drive(
        torch, name, go, _path_launches(cfg.n_layer, spec))
    return dict(out=out.cpu(), counts=counts.cpu(), stats=stats,
                total_s=seconds, launches=used)


# the hf_ruler phase: the main path's weights written as an HF checkpoint
# directory (HF_SHARDS safetensors files and their index; a pytorch_model.bin
# of the first HF_BIN_LAYERS layers), loaded back by the tail's loader and
# run on RULER prompts
HF_SHARDS, HF_BIN_LAYERS = 2, 2
RULER_TASK = "niah"
TRACE_NEW = 2               # new tokens of the traced SnapKV run: a round
STEP_ITERS = 10             # step_cost_report's timed AR steps
FIDELITY_PAGES = BUDGET // QUEST_PAGE   # selection_fidelity's n_pages: 8
# the hand-written kernels the trace must name (bf16 entries)
TRACED_KERNELS = ("decode_split_mma_kernel", "prefill_mma_kernel",
                  "block_gemm_kernel")


def hf_state_dict(torch, params, cfg):
    """The port's params as an HF LlamaForCausalLM state dict (the inverse
    of checkpoint/convert_hf.py's mapping), each tensor a CPU copy of its
    own: [out, in] weights, q/k/v split out of the KV-head-major wqkv,
    gate/up out of w_gate_up; no lm_head with tied embeddings."""
    L, D = cfg.n_layer, cfg.dim
    Dh, Hq, Hkv = cfg.head_dim, cfg.n_head, cfg.n_kv_head
    G = Hq // Hkv
    lp = params["layers"]
    sd = {"model.embed_tokens.weight": params["tok_embeddings"],
          "model.norm.weight": params["norm"]}
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = params["output"].t()
    for i in range(L):
        p = f"model.layers.{i}."
        w = lp["wqkv"][i].reshape(D, Hkv, G + 2, Dh)
        sd.update({
            p + "self_attn.q_proj.weight": w[:, :, :G].reshape(D, Hq * Dh).t(),
            p + "self_attn.k_proj.weight": w[:, :, G].reshape(D, Hkv * Dh).t(),
            p + "self_attn.v_proj.weight": w[:, :, G + 1].reshape(D, Hkv * Dh).t(),
            p + "self_attn.o_proj.weight": lp["wo"][i].t(),
            p + "mlp.gate_proj.weight": lp["w_gate_up"][i][:, 0].t(),
            p + "mlp.up_proj.weight": lp["w_gate_up"][i][:, 1].t(),
            p + "mlp.down_proj.weight": lp["w_down"][i].t(),
            p + "input_layernorm.weight": lp["attn_norm"][i],
            p + "post_attention_layernorm.weight": lp["ffn_norm"][i]})
    return {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in sd.items()}


def write_safetensors(torch, path, tensors):
    """One safetensors file (the card's machine has no safetensors
    package): the 8-byte little-endian header length, the JSON header
    (padded to 8 bytes), each tensor's bytes in order."""
    import struct

    tags = {torch.float32: "F32", torch.float16: "F16",
            torch.bfloat16: "BF16"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": tags[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.reshape(-1).view(torch.uint8).numpy())


def write_hf_dir(torch, d, state, shards):
    """state as HF's sharded layout in directory d: `shards` files of about
    equal bytes (model-0000i-of-0000n.safetensors, tensors in order) and
    model.safetensors.index.json with its weight_map."""
    d.mkdir(parents=True)
    total = sum(t.numel() * t.element_size() for t in state.values())
    groups, size = [{}], 0
    for name, t in state.items():
        if size >= total * len(groups) / shards and len(groups) < shards:
            groups.append({})
        groups[-1][name] = t
        size += t.numel() * t.element_size()
    weight_map = {}
    for i, group in enumerate(groups):
        fname = f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors"
        write_safetensors(torch, d / fname, group)
        weight_map.update(dict.fromkeys(group, fname))
    (d / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}))


def _hold_bits(torch, what, got, want):
    """Every leaf of got equals want's bit for bit, on want's device, in
    its dtype (None leaves alike)."""
    from magicdec_tpu_torch.checkpoint.store import flatten_params

    if (got["output"] is None) != (want["output"] is None):
        fail(f"{what}: output None in one of the two params")
    g, w = flatten_params(got), flatten_params(want)
    if sorted(g) != sorted(w):
        fail(f"{what}: leaves {sorted(g)} != {sorted(w)}")
    for key, t in w.items():
        if (g[key].device != t.device or g[key].dtype != t.dtype
                or not torch.equal(g[key], t)):
            fail(f"{what}: leaf {key} differs from the source params")


def _traced_kernels(trace_dir):
    """The device ms and launches by name of the kernels a trace written by
    device_trace records whose names contain TRACED_KERNELS'."""
    files = list(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        fail(f"hf_ruler: device_trace wrote {[f.name for f in files]}")
    events = json.loads(files[0].read_text())["traceEvents"]
    found = {k: {"launches": 0, "ms": 0.0} for k in TRACED_KERNELS}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for k in TRACED_KERNELS:
            if k in e.get("name", ""):
                found[k]["launches"] += 1
                found[k]["ms"] += e.get("dur", 0.0) / 1e3
    missing = [k for k, v in found.items() if not v["launches"]]
    if missing:
        fail(f"hf_ruler: the trace names no {missing}")
    return files[0].stat().st_size, found


def hf_ruler(torch, dev, params):
    """The tail on the main path: the main path's llama-3.2-1b params
    written as an HF checkpoint directory and loaded back bit for bit by
    load_hf_checkpoint (sharded safetensors by the directory's name; a
    .bin of the first layers with a config), then RULER niah prompts (B,
    P) through AR and SnapKV 1024 on the loaded weights (lossless, equal
    scores, launch counts), timed by PhaseClock, one short SnapKV run (on
    the .bin's layers) traced by device_trace, an AR step by
    step_cost_report, and selection_fidelity and find_alpha / best_gamma
    on the run. Returns the launch counts of its main-path runs."""
    import shutil
    import tempfile

    from magicdec_tpu_torch import analysis
    from magicdec_tpu_torch.checkpoint.convert_hf import load_hf_checkpoint
    from magicdec_tpu_torch.data import ruler
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import generate_selfspec
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.ops.norms import rms_norm
    from magicdec_tpu_torch.ops.rope import rope
    from magicdec_tpu_torch.utils.profiling import (PhaseClock, device_trace,
                                                    step_cost_report)

    cfg = ModelArgs.from_name("llama-3.2-1b")
    L = cfg.n_layer
    bin_cfg = cfg.replace(n_layer=HF_BIN_LAYERS)
    tmp = Path(tempfile.mkdtemp(prefix="hf_ruler-"))
    try:
        d, bin_dir = tmp / "llama-3.2-1b", tmp / "first-layers"
        t = time.perf_counter()
        write_hf_dir(torch, d, hf_state_dict(torch, params, cfg), HF_SHARDS)
        bin_dir.mkdir()
        torch.save(hf_state_dict(torch, _first_layers(params, HF_BIN_LAYERS),
                                 bin_cfg), bin_dir / "pytorch_model.bin")
        write_s = time.perf_counter() - t
        st_bytes = sum(f.stat().st_size for f in d.glob("*.safetensors"))
        bin_bytes = (bin_dir / "pytorch_model.bin").stat().st_size

        clock = PhaseClock()
        with clock.phase("load_safetensors", sync_on=params):
            loaded, got_cfg = load_hf_checkpoint(d)
        if got_cfg != cfg:
            fail(f"hf_ruler: the directory's name gave {got_cfg}")
        _hold_bits(torch, "hf_ruler safetensors", loaded, params)
        with clock.phase("load_bin", sync_on=params):
            first, _ = load_hf_checkpoint(bin_dir, config=bin_cfg)
        _hold_bits(torch, "hf_ruler .bin", first,
                   _first_layers(params, HF_BIN_LAYERS))

        prompts, answers = ruler.prepare(RULER_TASK, P, B)
        total = _zero()

        def prefill():
            eng = Engine(cfg, loaded, batch_size=B, max_len=MAX_LEN)
            with clock.phase("prefill", sync_on=loaded):
                tok = eng.encode(prompts)
            return eng, tok

        (eng, tok), used, _ = _drive(
            torch, "hf_ruler prefill", prefill,
            lambda r: dict(_zero(), flash_prefill=L * (P // 128)))
        total = _add(total, used)
        runs = {}
        for name, spec, budget in (("ar", None, 0),
                                   ("snapkv", "snapkv", BUDGET)):
            with clock.phase(name, sync_on=loaded):
                runs[name] = _spec_run(torch, cfg, loaded, prompts,
                                       "hf_ruler " + name, spec, budget)
            total = _add(total, runs[name]["launches"])
        ar = runs["ar"]["out"]
        _check_stream(torch, "hf_ruler snapkv", runs["snapkv"]["out"],
                      runs["snapkv"]["counts"], ar, cfg.vocab_size)
        scores = {k: ruler.score(RULER_TASK, r["out"].numpy(), answers)
                  for k, r in runs.items()}
        if scores["snapkv"] != scores["ar"]:
            fail(f"hf_ruler: RULER scores {scores} differ")

        # the traced round runs on the .bin's first layers, which keeps its
        # trace a sixth of a 16-layer round's size
        trace_dir = tmp / "trace"

        def traced():
            e = Engine(bin_cfg, first, batch_size=B, max_len=MAX_LEN,
                       spec="snapkv", draft_budget=BUDGET, window_size=WINDOW)
            with device_trace(str(trace_dir)):
                result = generate_selfspec(e, prompts, GAMMA, TRACE_NEW)
                torch.cuda.synchronize()
            return result

        _, used, trace_s = _drive(
            torch, "hf_ruler traced snapkv", traced,
            _path_launches(HF_BIN_LAYERS, "snapkv", new=TRACE_NEW))
        total = _add(total, used)
        del first
        trace_bytes, traced_kernels = _traced_kernels(trace_dir)

        # layer 0 of the prefilled cache and the last prompt position's
        # rotated query
        lp = loaded["layers"]
        x = llama.embed(loaded, cfg, torch.as_tensor(prompts[:, -1],
                                                     device=dev))
        qkv = rms_norm(x, lp["attn_norm"][0], cfg.norm_eps).float() @ \
            lp["wqkv"][0].float()
        q = llama._split_qkv(qkv[:, None], cfg)[0]
        q = rope(cfg, q, torch.full((B, 1), P - 1, device=dev))[:, 0]
        fidelity = analysis.selection_fidelity(
            q, eng.cache.k[0][:, :P], eng.cache.lengths, page=QUEST_PAGE,
            n_pages=FIDELITY_PAGES)
        if not (all(0.0 <= v <= 1.0 + 1e-6 for v in fidelity.values())
                and fidelity["perhead_true"] >= fidelity["joint"] - 1e-6
                and fidelity["perhead_true"] >= fidelity["perhead_box"] - 1e-6):
            fail(f"hf_ruler: selection_fidelity {fidelity} breaks its "
                 f"ordering")

        state = {"tok": tok}

        def ar_step():
            state["tok"] = eng.inference(state["tok"])
            return state["tok"]

        cost, used, _ = _drive(
            torch, "hf_ruler ar step",
            lambda: step_cost_report(ar_step, iters=STEP_ITERS,
                                     label="ar_step"),
            lambda r: dict(_zero(), flash_decode_stacked=L * (STEP_ITERS + 1),
                           **_fused_pair(L * (STEP_ITERS + 1))))
        total = _add(total, used)
        del eng, state

        s = runs["snapkv"]["stats"]
        rate = s.acceptance_rate
        ar_ms = cost["ar_step"]["ms"]
        round_ms = s.wall_time_s / s.rounds * 1e3
        ratio = max(round_ms - ar_ms, 0.0) / GAMMA / ar_ms
        alpha = analysis.find_alpha(GAMMA, rate)
        timings = clock.report()
        line(phase="hf_ruler", model="llama-3.2-1b", dtype="bfloat16",
             safetensors_shards=HF_SHARDS, safetensors_bytes=st_bytes,
             bin_layers=HF_BIN_LAYERS, bin_bytes=bin_bytes, write_s=write_s,
             load_safetensors_gb_s=st_bytes / 1e9 / timings[
                 "load_safetensors"]["total_s"],
             bits_equal=True, task=RULER_TASK, B=B, P=P, new_tokens=NEW,
             gamma=GAMMA, budget=BUDGET, scores=scores, lossless=True,
             acceptance=rate, rounds=s.rounds,
             tok_s={k: r["stats"].generated_tokens / r["stats"].wall_time_s
                    for k, r in runs.items()},
             phase_clock=timings, ar_step=cost["ar_step"],
             traced_run={"layers": HF_BIN_LAYERS, "new_tokens": TRACE_NEW,
                         "seconds": trace_s,
                         "trace_bytes": trace_bytes,
                         "kernels": traced_kernels},
             selection_fidelity=fidelity, alpha=alpha,
             round_ms=round_ms, draft_cost_ratio=ratio,
             best_gamma=analysis.best_gamma(alpha, ratio),
             launches={k: v for k, v in total.items() if v})
        del loaded
        torch.cuda.empty_cache()
        return total
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def longspec(torch, dev, params, prompt, ar):
    """Two-model SD: llama-3.2-1b target; a self-draft over its full KV, and
    a DRAFT_LAYERS-layer draft of the same widths with its own weights in
    each draft mode."""
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.longspec import LongSpecEngine
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("llama-3.2-1b")
    small = cfg.replace(n_layer=DRAFT_LAYERS)
    sparams = llama.init_params(small, torch.bfloat16, scale=0.3, seed=1,
                                device=dev)
    cases = {"self_full": (cfg, params, None, 0),
             "small_full": (small, sparams, None, 0),
             "small_snapkv": (small, sparams, "snapkv", BUDGET),
             "small_streaming": (small, sparams, "streaming", BUDGET)}
    L, chunks = cfg.n_layer, P // 128
    res, total = {}, _zero()
    for name, (dcfg, dparams, spec, budget) in cases.items():
        Ld = dcfg.n_layer

        def go():
            target = Engine(cfg, params, batch_size=B, max_len=MAX_LEN)
            draft = Engine(dcfg, dparams, batch_size=B, max_len=MAX_LEN,
                           spec=spec, draft_budget=budget, window_size=WINDOW,
                           sink_size=SINK, draft_headroom=STREAM_HEADROOM)
            return LongSpecEngine(target, draft).generate(prompt, GAMMA, NEW)

        def expect(result):
            r = result[-1].rounds
            draft = Ld * GAMMA * r
            return dict(_zero(), flash_prefill=(L + Ld) * chunks,
                        flash_decode_stacked=L * r + (
                            0 if spec == "streaming" else draft),
                        flash_decode_intervals=(draft if spec == "streaming"
                                                else 0),
                        **_fused_pair(L * r + draft))

        (out, counts, stats), used, seconds = _drive(torch, name, go, expect)
        _check_stream(torch, f"longspec {name}", out, counts, ar,
                      cfg.vocab_size)
        res[name] = dict(acceptance=stats.acceptance_rate, rounds=stats.rounds,
                         tok_s=stats.generated_tokens / stats.wall_time_s,
                         run_s=seconds, launches=used)
        total = _add(total, used)
    if res["self_full"]["acceptance"] != 1.0:
        fail(f"longspec self-draft acceptance {res['self_full']['acceptance']}"
             f" != 1.0")
    line(phase="longspec", target="llama-3.2-1b", draft_layers=DRAFT_LAYERS,
         budget=BUDGET, gamma=GAMMA, runs=res, lossless=True,
         self_draft_acceptance=1.0)
    return total


def quant_and_fused(torch, dev, params, prompt):
    """llama-3.2-1b at full width with weights quantized on the card from the
    main path's seeded bf16 ones (int8: AR and SnapKV at full budget; int4:
    AR, SnapKV 1024 and full budget), then with the main path's bf16
    weights and the fused decode block off (set_fused_mode("off"): AR,
    SnapKV 1024 and full budget on the padded rows; the main path runs them
    fused, the default). Each speculative stream must equal its own AR
    stream, each full budget must accept exactly 1.0, and the launch counts
    must be those the path implies: int4_matmul 4 L per forward (prefill
    chunks included), no fused pair (quantized weights and the "off" mode
    take the unfused path)."""
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                                generate_selfspec)
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.quant.int8 import quantize_params

    cfg = ModelArgs.from_name("llama-3.2-1b")
    L, chunks = cfg.n_layer, P // 128
    runs, total = {}, _zero()

    def expect(spec, mode):
        def launches(result):
            r = result[-1].rounds
            steps = NEW - 1 if spec is None else (GAMMA + 1) * r
            want = dict(_zero(), flash_prefill=L * chunks,
                        flash_decode_stacked=L * steps)
            if mode == "int4":
                want["int4_matmul"] = 4 * L * (chunks + steps)
            return want
        return launches

    def run(mode, w, spec, budget):
        name = f"{mode}_{spec or 'ar'}" + ("_full" if budget == P else "")

        def go():
            eng = Engine(cfg, w, batch_size=B, max_len=MAX_LEN, spec=spec,
                         draft_budget=budget, window_size=WINDOW)
            if spec is None:
                out, stats = generate_autoregressive(eng, prompt, NEW)
                return out, torch.full((B,), NEW, dtype=torch.int32), stats
            return generate_selfspec(eng, prompt, GAMMA, NEW)

        (out, counts, stats), used, seconds = _drive(torch, name, go,
                                                     expect(spec, mode))
        runs[name] = dict(out=out.cpu(), counts=counts.cpu(), stats=stats,
                          total_s=seconds, launches=used, mode=mode)
        total.update(_add(total, used))

    for mode in ("int8", "int4"):
        t0 = time.perf_counter()
        qparams = quantize_params(params, mode)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        run(mode, qparams, None, 0)
        if mode == "int4":
            run(mode, qparams, "snapkv", BUDGET)
        run(mode, qparams, "snapkv", P)
        runs[f"{mode}_ar"]["quantize_s"] = quant_s
        del qparams
        torch.cuda.empty_cache()
    with _fused_mode(llama, "off"):
        run("unfused", params, None, 0)
        run("unfused", params, "snapkv", BUDGET)
        run("unfused", params, "snapkv", P)

    for name, r in runs.items():
        if name.endswith("_ar"):
            continue
        _check_stream(torch, name, r["out"], r["counts"],
                      runs[f"{r['mode']}_ar"]["out"], cfg.vocab_size)
        if name.endswith("_full") and r["stats"].acceptance_rate != 1.0:
            fail(f"{name}: full-budget acceptance "
                 f"{r['stats'].acceptance_rate} != 1.0 (invariant 2)")
    spec_runs = [k for k in runs if not k.endswith("_ar")]
    line(phase="quant_and_fused", model="llama-3.2-1b", B=B, P=P,
         new_tokens=NEW, gamma=GAMMA, budget=BUDGET,
         quantize_s={m: runs[f"{m}_ar"]["quantize_s"] for m in ("int8", "int4")},
         tok_s={k: r["stats"].generated_tokens / r["stats"].wall_time_s
                for k, r in runs.items()},
         acceptance={k: runs[k]["stats"].acceptance_rate for k in spec_runs},
         rounds={k: runs[k]["stats"].rounds for k in spec_runs},
         run_s={k: r["total_s"] for k, r in runs.items()},
         decode_s={k: r["stats"].wall_time_s for k, r in runs.items()},
         launches={k: r["launches"] for k, r in runs.items()},
         invariant1=True, invariant2=True)
    return total


GLIDE_SEED, GLIDE_SCALE = 5, 0.3      # the glide block's random params
GLIDE_STOCH_ROUNDS = 4
GLIDE_F32_P = 1024                     # the f32 phase's prompt, cut from P


def _glide_expect(L, chunks, tree):
    """The launch counts a GlideEngine.generate run implies: the target's
    prefill (L per chunk) and the glide's (2 per chunk: self- and
    cross-attention); per round, linear (tree None): 2 (gamma + 1) flat
    decode launches (gamma drafts and the appending forward) and L verify
    launches; tree: per level and leaf level one intervals launch with
    return_lse (self-attention) and one without (cross-attention), and L
    verify launches with return_lse per chunk of 16 nodes."""
    def launches(result):
        r = result[-1].rounds
        want = dict(_zero(), flash_prefill=(L + 2) * chunks,
                    **_fused_pair(L * r))
        if tree is None:
            want.update(flash_decode_intervals=2 * (GAMMA + 1) * r,
                        flash_decode_stacked=L * r)
        else:
            levels = len(tree.branching) + 1
            want.update(flash_decode_intervals=levels * r,
                        flash_decode_intervals_lse=levels * r,
                        flash_decode_stacked_lse=L * r * -(-tree.n_nodes // 16))
        return want
    return launches


def _prefix_share(torch, out, counts, ar):
    """Per sequence, the share of its tokens (up to NEW) that match the AR
    stream before the first divergence."""
    out = out.cpu()
    shares = []
    for b in range(out.shape[0]):
        n = min(int(counts[b]), NEW)
        same = (out[b, :n] == ar[b, :n]).to(torch.int32)
        shares.append(float(torch.cumprod(same, 0).sum()) / n)
    return shares


def glide(torch, dev, params, prompt, ar):
    """GliDe at llama-3.2-1b full width (the main path's bf16 weights, B=8,
    P=4096, 64 new tokens) with a random glide block (torch.Generator seed
    GLIDE_SEED, scale GLIDE_SCALE): linear (gamma 6), greedy tree (2,2) (7
    nodes, 56 verify rows) and (4,2,2) (29 nodes: two verify launches a
    layer), and GLIDE_STOCH_ROUNDS stochastic tree (2,2) rounds after an
    encode. The linear stream must equal the AR stream (invariant 1); the
    tree streams' share matching AR before their first divergence is
    printed (a tree verify may flip argmax at a near-tie, as in the JAX
    package); the stochastic rounds must emit 1..depth+1 tokens and advance
    both caches by it. Every run's launch counts as its path implies."""
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.glide_engine import (
        GlideEngine, SpecTree, glide_tree_round_stochastic)
    from magicdec_tpu_torch.engine.spec import SpecStats, _eot_array
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.models.glide import init_glide_params

    cfg = ModelArgs.from_name("llama-3.2-1b")
    L, chunks = cfg.n_layer, P // 128
    gp = init_glide_params(cfg, torch.bfloat16, scale=GLIDE_SCALE,
                           seed=GLIDE_SEED, device=dev)
    res, total, outs = {}, _zero(), {}
    for name, branching in (("linear", None), ("tree_2_2", (2, 2)),
                            ("tree_4_2_2", (4, 2, 2))):
        tree = None if branching is None else SpecTree(branching)

        def go():
            eng = GlideEngine(Engine(cfg, params, batch_size=B,
                                     max_len=MAX_LEN), gp)
            return eng.generate(prompt, NEW, gamma=GAMMA, tree=tree)

        (out, counts, stats), used, seconds = _drive(
            torch, f"glide {name}", go, _glide_expect(L, chunks, tree))
        if out.min() < 0 or out.max() >= cfg.vocab_size:
            fail(f"glide {name}: token ids out of range")
        outs[name] = (out, counts)
        res[name] = dict(rounds=stats.rounds, acceptance=stats.acceptance_rate,
                         tok_s=stats.generated_tokens / stats.wall_time_s,
                         decode_s=stats.wall_time_s, run_s=seconds,
                         launches=used)
        total = _add(total, used)
    _check_stream(torch, "glide linear", *outs["linear"], ar, cfg.vocab_size)
    shares = {k: _prefix_share(torch, *outs[k], ar)
              for k in ("tree_2_2", "tree_4_2_2")}

    tree = SpecTree((2, 2))
    depth1 = len(tree.branching) + 1
    rounds = []

    def go_stochastic():
        eng = GlideEngine(Engine(cfg, params, batch_size=B, max_len=MAX_LEN),
                          gp)
        root = eng.encode(prompt)
        gen = torch.Generator(device=dev).manual_seed(3)
        eot = _eot_array((), dev)
        cache = eng.target.cache
        for _ in range(GLIDE_STOCH_ROUNDS):
            before = cache.lengths.clone()
            own_len, emitted, emit_len, root, _ = glide_tree_round_stochastic(
                params, gp, cfg, tree, cache, eng.own_k, eng.own_v,
                eng.own_len, root, eot, gen, use_flash=eng.use_flash)
            eng.own_len = own_len
            el = emit_len.cpu()
            if (emitted.shape != (B, depth1) or root.shape != (B, 1)
                    or not bool(((el >= 1) & (el <= depth1)).all())
                    or not torch.equal((cache.lengths - before).cpu(), el)
                    or not torch.equal(own_len.cpu(), cache.lengths.cpu())):
                fail("glide stochastic: a round's shapes, emit_len or cache "
                     "lengths are wrong")
            rounds.append(el.tolist())
        return None, None, SpecStats(rounds=GLIDE_STOCH_ROUNDS)

    _, used, seconds = _drive(torch, "glide stochastic", go_stochastic,
                              _glide_expect(L, chunks, tree))
    total = _add(total, used)
    res["stochastic_tree_2_2"] = dict(emit_len_per_round=rounds, run_s=seconds,
                                      launches=used)
    line(phase="glide", model="llama-3.2-1b", dtype="bfloat16", B=B, P=P,
         new_tokens=NEW, gamma=GAMMA, glide_seed=GLIDE_SEED,
         glide_scale=GLIDE_SCALE, runs=res, invariant1_linear=True,
         tree_share_matching_ar_before_divergence=shares)
    return total


def glide_f32(torch, dev, params, prompt):
    """The same model in float32 weights and caches, the prompt cut to its
    first GLIDE_F32_P tokens: the greedy tree (2,2) stream must equal the
    float32 AR stream (the card's form of tests/test_glide.py's tree
    losslessness test)."""
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.glide_engine import GlideEngine, SpecTree
    from magicdec_tpu_torch.engine.spec import generate_autoregressive
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.models.glide import init_glide_params

    cfg = ModelArgs.from_name("llama-3.2-1b")
    L, chunks = cfg.n_layer, GLIDE_F32_P // 128
    p32 = _to(params, torch.float32)
    gp = init_glide_params(cfg, torch.float32, scale=GLIDE_SCALE,
                           seed=GLIDE_SEED, device=dev)
    pr = prompt[:, :GLIDE_F32_P]
    max_len = GLIDE_F32_P + NEW + 2 * GAMMA + 16
    tree = SpecTree((2, 2))

    def go_ar():
        out, stats = generate_autoregressive(
            Engine(cfg, p32, batch_size=B, max_len=max_len), pr, NEW)
        return out, torch.full((B,), NEW, dtype=torch.int32), stats

    def go_tree():
        return GlideEngine(Engine(cfg, p32, batch_size=B, max_len=max_len),
                           gp).generate(pr, NEW, tree=tree)

    (ar, _, ar_stats), used_ar, s_ar = _drive(
        torch, "glide_f32 ar", go_ar, lambda r: dict(
            _zero(), flash_prefill=L * chunks,
            flash_decode_stacked=L * (NEW - 1), **_fused_pair(L * (NEW - 1))))
    (out, counts, stats), used, seconds = _drive(
        torch, "glide_f32 tree_2_2", go_tree, _glide_expect(L, chunks, tree))
    _check_stream(torch, "glide_f32 tree_2_2", out, counts, ar.cpu(),
                  cfg.vocab_size)
    line(phase="glide_f32", model="llama-3.2-1b", dtype="float32", B=B,
         P=GLIDE_F32_P, P_cut_from=P, new_tokens=NEW,
         tree=list(tree.branching), rounds=stats.rounds,
         acceptance=stats.acceptance_rate,
         tok_s={"ar": ar_stats.generated_tokens / ar_stats.wall_time_s,
                "tree_2_2": stats.generated_tokens / stats.wall_time_s},
         run_s={"ar": s_ar, "tree_2_2": seconds},
         launches={"ar": used_ar, "tree_2_2": used}, tree_equals_ar=True)
    del p32, gp
    torch.cuda.empty_cache()
    return _add(used_ar, used)


# ---------------------------------------------------------------------------
# phases 12h-12i: continuous batching and host offload
# ---------------------------------------------------------------------------

# benchmarks/serve_benchmark.py:44's max_new_tokens spread, cycled over the
# requests; its max_len (P + max(spread) + gamma + 8, :69)
SERVE_SPREAD = (16, 32, 48, 64, 96, 128)
SERVE_REQUESTS, SERVE_SOLO = 16, 4
SERVE_MAX_LEN = P + max(SERVE_SPREAD) + GAMMA + 8
# the offload phase: n_clusters x cap = P clusters of the prefix per
# (layer, sequence), a tail of the newest 512 rows, 8 clusters attended a
# token (a 512-row working set), gamma 4. 64 clusters, so a spec round's
# union (at most (gamma + 1) x nprobe = 40) is a selective fetch and an LRU
# of that many slots can evict (at 32 x 128 the union was every cluster
# and the LRU a full device copy of the store)
OFFLOAD_C, OFFLOAD_CAP, OFFLOAD_KEEP, OFFLOAD_NPROBE = 64, 64, 512, 8
OFFLOAD_GAMMA, OFFLOAD_NEW = 4, 32


def _nonzero(counts):
    """The kernels a run launched, with their counts."""
    return {k: v for k, v in counts.items() if v}


def _serve_expect(L):
    """The launch counts a ServeEngine run implies (its engine first in the
    result): its staging prefill (L per 128-token chunk of P) per
    admission, and L (gamma + 1) decode launches per round (gamma draft
    steps, one verify)."""
    def launches(result):
        srv = result[0]
        return dict(_zero(), flash_prefill=L * (P // 128) * srv.admissions,
                    flash_decode_stacked=L * (GAMMA + 1) * srv.rounds,
                    **_fused_pair(L * (GAMMA + 1) * srv.rounds))
    return launches


def serve(torch, dev, params):
    """Continuous batching (engine/serve.py) at llama-3.2-1b full width
    (the main path's bf16 weights), a B=8 frame, P=4096, gamma 6,
    SERVE_REQUESTS requests with max_new_tokens cycled from SERVE_SPREAD.
    (a) Budget 1024: useful tokens/s of static batching (groups of B in
    arrival order, each run by generate_selfspec to its longest member, as
    benchmarks/serve_benchmark.py:71-90) against ServeEngine (:92-104),
    with rounds, occupancy and host reads per round. (b) Full budget
    (budget = P): acceptance exactly 1.0. (c) SERVE_SOLO of the requests
    alone (B=1 generate_selfspec at full budget): each served stream's
    share matching its solo stream before a divergence (a B=1 decode runs
    its products at other row counts than the B-row frame, so a bf16
    stream may leave the other at a near-tie). Launch counts of every run
    as its rounds and admissions imply."""
    import numpy as np

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.serve import Request, ServeEngine
    from magicdec_tpu_torch.engine.spec import generate_selfspec
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("llama-3.2-1b")
    L = cfg.n_layer
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                                (SERVE_REQUESTS, P))
    new_lens = [SERVE_SPREAD[i % len(SERVE_SPREAD)]
                for i in range(SERVE_REQUESTS)]
    useful = sum(new_lens)
    cap = max(SERVE_SPREAD)

    def go_static():
        eng = Engine(cfg, params, batch_size=B, max_len=SERVE_MAX_LEN,
                     spec="snapkv", draft_budget=BUDGET, window_size=WINDOW)
        outs, rounds = {}, 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g0 in range(0, SERVE_REQUESTS, B):
            idx = list(range(g0, min(g0 + B, SERVE_REQUESTS)))
            idx += [idx[-1]] * (B - len(idx))           # pad the last group
            eng.clear_kv()
            out, counts, st = generate_selfspec(
                eng, prompts[idx], GAMMA, max(new_lens[i] for i in idx))
            rounds += st.rounds
            for r, i in enumerate(idx):
                outs[i] = out[r, :new_lens[i]].cpu().numpy()
        torch.cuda.synchronize()
        return outs, rounds, time.perf_counter() - t0

    groups = -(-SERVE_REQUESTS // B)
    (static_out, static_rounds, static_s), used_static, _ = _drive(
        torch, "serve static", go_static, lambda r: dict(
            _zero(), flash_prefill=L * (P // 128) * groups,
            flash_decode_stacked=L * (GAMMA + 1) * r[1],
            **_fused_pair(L * (GAMMA + 1) * r[1])))

    def go_serve(budget):
        def go():
            srv = ServeEngine(cfg, params, batch_size=B,
                              max_len=SERVE_MAX_LEN, draft_budget=budget,
                              gamma=GAMMA, max_new_cap=cap,
                              window_size=WINDOW)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = srv.run([Request(i, prompts[i], new_lens[i])
                            for i in range(SERVE_REQUESTS)])
            torch.cuda.synchronize()
            return srv, done, time.perf_counter() - t0
        return go

    runs = {}
    for name, budget in (("serve", BUDGET), ("serve_full", P)):
        (srv, done, seconds), used, _ = _drive(
            torch, name, go_serve(budget), _serve_expect(L))
        if sorted(c.req_id for c in done) != list(range(SERVE_REQUESTS)):
            fail(f"{name}: not every request completed")
        for c in done:
            t = np.asarray(c.tokens)
            if (len(t) != new_lens[c.req_id] or t.min() < 0
                    or t.max() >= cfg.vocab_size):
                fail(f"{name}: request {c.req_id} gave {len(t)} tokens "
                     f"(asked {new_lens[c.req_id]}) or ids out of range")
        if srv.host_reads != srv.rounds:
            fail(f"{name}: {srv.host_reads} host reads in {srv.rounds} "
                 f"rounds (one a round)")
        runs[name] = (srv, used, done, seconds)
    full, _, full_done, _ = runs["serve_full"]
    if full.acceptance_rate != 1.0:
        fail(f"serve_full: full-budget acceptance {full.acceptance_rate} "
             f"!= 1.0 (invariant 2)")

    served = {c.req_id: np.asarray(c.tokens) for c in full_done}
    solo, used_solo, shares = {}, _zero(), []
    for i in range(SERVE_SOLO):
        def go_solo(i=i):
            eng = Engine(cfg, params, batch_size=1, max_len=SERVE_MAX_LEN,
                         spec="snapkv", draft_budget=P, window_size=WINDOW)
            return generate_selfspec(eng, prompts[i:i + 1], GAMMA,
                                     new_lens[i])

        (out, _, st), used, _ = _drive(
            torch, f"serve solo {i}", go_solo, lambda r: dict(
                _zero(), flash_prefill=L * (P // 128),
                flash_decode_stacked=L * (GAMMA + 1) * r[-1].rounds,
                **_fused_pair(L * (GAMMA + 1) * r[-1].rounds)))
        used_solo = _add(used_solo, used)
        want = out[0, :new_lens[i]].cpu().numpy()
        same = np.cumprod(served[i] == want)
        shares.append(float(same.sum()) / new_lens[i])

    def static_share(c):
        same = np.cumprod(np.asarray(c.tokens) == static_out[c.req_id])
        return float(same.sum()) / len(c.tokens)

    def stats(name):
        srv, _, done, seconds = runs[name]
        return dict(rounds=srv.rounds, occupancy=srv.occupancy,
                    host_reads_per_round=srv.host_reads / srv.rounds,
                    admissions=srv.admissions,
                    acceptance=srv.acceptance_rate, seconds=seconds,
                    useful_tok_s=sum(len(c.tokens) for c in done) / seconds)

    serve_done = runs["serve"][2]
    line(phase="serve", model="llama-3.2-1b", dtype="bfloat16", B=B, P=P,
         gamma=GAMMA, requests=SERVE_REQUESTS, new_spread=list(SERVE_SPREAD),
         useful_tokens=useful, budget=BUDGET,
         static={"rounds": static_rounds, "seconds": static_s,
                 "useful_tok_s": useful / static_s, "groups": groups},
         serve=stats("serve"), serve_over_static=(
             stats("serve")["useful_tok_s"] / (useful / static_s)),
         served_share_matching_static_before_divergence=[
             static_share(c) for c in sorted(serve_done,
                                             key=lambda c: c.req_id)],
         full_budget=stats("serve_full"), full_budget_acceptance_is_one=True,
         solo_share_matching_served_before_divergence=shares,
         launches={k: _nonzero(v) for k, v in (
             ("static", used_static), ("serve", runs["serve"][1]),
             ("serve_full", runs["serve_full"][1]), ("solo", used_solo))},
         card=_card())
    total = _add(_add(used_static, used_solo),
                 _add(runs["serve"][1], runs["serve_full"][1]))
    del runs, full, full_done, serve_done
    torch.cuda.empty_cache()
    return total


def offload(torch, dev, params, prompt):
    """Host offload (engine/offload.py) at llama-3.2-1b full width (the
    main path's bf16 weights), B=8, P=4096: offload_prefill into a
    HostBlockStore of OFFLOAD_C x OFFLOAD_CAP = P clusters a (layer,
    sequence), its peak device memory beside an Engine.encode's at the same
    shape; then OFFLOAD_NEW tokens of offload_generate through the host
    store, which must equal its device twin (device_fetch_fn over the same
    blocks on the card) token for token; offload_generate_hostloop, equal
    to offload_generate, and again through a ClusterLRU of nprobe + 2
    slots, which must evict and give the same stream;
    offload_generate_spec (gamma 4), equal to the hostloop stream, with and
    without a ClusterLRU holding the round's union (with it the host
    fetches fewer slots and the hit rate is above 0). The round's union
    (at most 40 clusters) is a strict subset of the 64, so the union fetch
    is selective and the union-sized LRU can evict too. Prints tok/s of each, the host store's bytes, host fetches and
    bytes a step or round, the pinned copy's GB/s and the host gather's.
    flash_prefill launches L x P/128 in the prefill; the decode launches
    no kernel (dense masked attention, as in the JAX package)."""
    import numpy as np

    from magicdec_tpu_torch.engine import offload as off
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs.from_name("llama-3.2-1b")
    L = cfg.n_layer
    HD = cfg.n_kv_head * cfg.head_dim
    store = off.HostBlockStore(L, B, OFFLOAD_C, OFFLOAD_CAP, HD,
                               torch.bfloat16)
    kw = dict(nprobe=OFFLOAD_NPROBE, cap=OFFLOAD_CAP)

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    def go_prefill():
        return peak(lambda: off.offload_prefill(
            params, cfg, store, prompt, n_clusters=OFFLOAD_C,
            cap=OFFLOAD_CAP, tail_keep=OFFLOAD_KEEP))

    ((state, buffer0), prefill_peak), used_prefill, prefill_s = _drive(
        torch, "offload prefill", go_prefill, lambda r: dict(
            _zero(), flash_prefill=L * (P // 128)))

    def go_encode():
        eng = Engine(cfg, params, batch_size=B, max_len=MAX_LEN)
        return eng.encode(prompt)

    (engine_tok, encode_peak), used_encode, _ = _drive(
        torch, "offload engine encode", lambda: peak(go_encode),
        lambda r: dict(_zero(), flash_prefill=L * (P // 128)))

    every = np.tile(np.arange(OFFLOAD_C), (B, 1))
    dev_blocks = torch.stack([store.gather_clusters(l, every)
                              for l in range(L)]).to(dev)

    def run(name, fn):
        before = (store.fetches, store.bytes_fetched, store.buf.gathered_slots)

        def go():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        (out, seconds), used, _ = _drive(torch, f"offload {name}", go,
                                         lambda r: _zero())
        toks = out[0].cpu()
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"offload {name}: token ids out of range")
        return dict(tokens=toks, seconds=seconds, used=used,
                    stats=out[2] if len(out) > 2 else None,
                    fetches=store.fetches - before[0],
                    bytes=store.bytes_fetched - before[1],
                    slots=store.buf.gathered_slots - before[2])

    res = {"gen_host": run("generate host", lambda: off.offload_generate(
               params, cfg, state, store, buffer0, OFFLOAD_NEW, **kw)),
           "gen_device": run("generate device twin",
                             lambda: off.offload_generate(
                                 params, cfg, state, store, buffer0,
                                 OFFLOAD_NEW,
                                 fetch_fn=off.device_fetch_fn(dev_blocks),
                                 **kw)),
           "hostloop": run("hostloop", lambda: off.offload_generate_hostloop(
               params, cfg, state, store, buffer0, OFFLOAD_NEW, **kw)),
           "spec": run("spec", lambda: off.offload_generate_spec(
               params, cfg, state, store, buffer0, OFFLOAD_NEW,
               gamma=OFFLOAD_GAMMA, **kw))}
    small = off.ClusterLRU(store, nslots=OFFLOAD_NPROBE + 2)
    res["hostloop_lru"] = run("hostloop lru", lambda: (
        off.offload_generate_hostloop(params, cfg, state, store, buffer0,
                                      OFFLOAD_NEW, lru=small, **kw)))
    U = min(OFFLOAD_C, (OFFLOAD_GAMMA + 1) * OFFLOAD_NPROBE)
    if U >= OFFLOAD_C:
        fail(f"offload: a round's union of {U} clusters is the whole store "
             f"of {OFFLOAD_C}; the union fetch would not be selective")
    lru = off.ClusterLRU(store, nslots=U)
    res["spec_lru"] = run("spec lru", lambda: off.offload_generate_spec(
        params, cfg, state, store, buffer0, OFFLOAD_NEW,
        gamma=OFFLOAD_GAMMA, lru=lru, **kw))
    del dev_blocks

    def equal(a, b, n=OFFLOAD_NEW):
        return torch.equal(res[a]["tokens"][:, :n], res[b]["tokens"][:, :n])

    for a, b, what in (("gen_host", "gen_device", "its device twin"),
                       ("hostloop", "gen_host", "offload_generate"),
                       ("hostloop_lru", "hostloop",
                        "the hostloop without the LRU"),
                       ("spec", "hostloop", "the hostloop stream"),
                       ("spec_lru", "spec", "spec without the LRU")):
        if not equal(a, b):
            fail(f"offload: {a}'s stream differs from {what}")
    if not (res["spec_lru"]["slots"] < res["spec"]["slots"]
            and lru.hit_rate > 0):
        fail(f"offload: the LRU fetched {res['spec_lru']['slots']} slots "
             f"against {res['spec']['slots']} (hit rate {lru.hit_rate})")
    if not small.evictions:
        fail(f"offload: the {small.nslots}-slot LRU never evicted "
             f"({small.misses} misses)")

    # the pinned copy's and the host gather's rates, at one union fetch
    ids = store.slot_ids(0, np.tile(np.arange(U), (B, 1)))
    nbytes = len(ids) * store.slot_bytes
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    gather_s, copy_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        store.buf.gather(ids, out=host)
        gather_s.append(time.perf_counter() - t0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out.copy_(host, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        copy_ms.append(start.elapsed_time(end))

    def rate(r):
        st = r["stats"]
        n = st["generated"] if st else B * OFFLOAD_NEW
        steps = st["rounds"] if st else OFFLOAD_NEW - 1
        return dict(tok_s=n / r["seconds"], seconds=r["seconds"],
                    host_fetches_per_step=r["fetches"] / steps,
                    host_bytes_per_step=r["bytes"] / steps,
                    slots_fetched=r["slots"], rounds=st and st["rounds"],
                    acceptance=st and (st["accepted_drafts"]
                                       / st["total_drafted"]))

    line(phase="offload", model="llama-3.2-1b", dtype="bfloat16", B=B, P=P,
         n_clusters=OFFLOAD_C, cap=OFFLOAD_CAP, tail_keep=OFFLOAD_KEEP,
         nprobe=OFFLOAD_NPROBE, gamma=OFFLOAD_GAMMA, new_tokens=OFFLOAD_NEW,
         host_store_bytes=store.buf.n_slots * store.slot_bytes,
         prefill_s=prefill_s, prefill_peak_bytes=prefill_peak,
         engine_encode_peak_bytes=encode_peak,
         prefill_first_token_equals_engine=bool(torch.equal(
             buffer0.cpu(), engine_tok.cpu())),
         runs={k: rate(r) for k, r in res.items()},
         lru={"nslots": U, "hits": lru.hits, "misses": lru.misses,
              "evictions": lru.evictions, "hit_rate": lru.hit_rate},
         hostloop_lru={"nslots": small.nslots, "hits": small.hits,
                       "misses": small.misses,
                       "evictions": small.evictions,
                       "hit_rate": small.hit_rate},
         union_fetch_bytes=nbytes,
         pinned_copy_gb_s=nbytes / (min(copy_ms) * 1e-3) / 1e9,
         host_gather_gb_s=nbytes / min(gather_s) / 1e9,
         host_equals_device_twin=True, hostloop_equals_generate=True,
         hostloop_lru_equals_hostloop=True, spec_equals_hostloop=True,
         lru_equals_spec=True,
         launches={"prefill": _nonzero(used_prefill),
                   "engine_encode": _nonzero(used_encode)},
         card=_card())
    del state, lru, small, store, host, out
    torch.cuda.empty_cache()
    return _add(used_prefill, used_encode)


# bench.py:57-59's BENCH_MODEL, the model the JAX package trains and
# benchmarks (8 layers, dim 1024, 16/8 heads of 64, FFN 2816, vocab 4096,
# tied embeddings); bench.py's training protocol: mixed_markov_dataset of
# TRAIN_SEQS sequences of TRAIN_SEQ tokens (seed 7), batch 8, lr 1e-3, f32
# master weights, PROTOCOL_STEPS steps, here cut to TRAIN_STEPS
BENCH_MODEL = dict(block_size=8192, vocab_size=4096, n_layer=8, n_head=16,
                   n_kv_head=8, dim=1024, intermediate_size=2816,
                   rope_base=500000.0, tie_word_embeddings=True)
TRAIN_SEQ, TRAIN_SEQS, TRAIN_BATCH, TRAIN_LR, TRAIN_SEED = 2048, 2048, 8, \
    1e-3, 7
# (200 until the serve and offload phases came: 100 keeps the script's
# time. The shorter cosine schedule ends lower: 2.70 nats at 100 steps
# against 2.91 at 200, where SnapKV 1024 accepted 0.9875 against 1.0)
PROTOCOL_STEPS, TRAIN_STEPS = 1200, 100
TRAINED_LOSS_MAX = 4.0          # nats; ln 4096 = 8.32 at init
# bench.py's GliDe block: mixed_markov_dataset(1024, 1024, seed 7), batch 8,
# lr 1e-3, train_glide's default seed, PROTOCOL_GLIDE_STEPS steps (bench.py's
# --glide_train_steps), here cut to GLIDE_STEPS
GLIDE_SEQ, GLIDE_SEQS, GLIDE_STEPS = 1024, 1024, 60
PROTOCOL_GLIDE_STEPS = 800
HELD_OUT_SEED = 10_000          # bench.py's held-out prompts (seed 10_000)
# the card-vs-CPU training check: three make_train_step steps of the small
# f32 model; losses within 1e-5 relative, first moments within 1e-4 of each
# leaf's largest element, params within 1e-4 of each leaf's update (mean
# error over mean update: Adam carries a tiny gradient's f32 error into a
# full-size update, so the largest element's error says little)
STEP_LOSS_TOL, STEP_MU_TOL, STEP_PARAM_TOL = 1e-5, 1e-4, 1e-4


def _three_steps(torch, dev, cfg, params, batches, tf32=False):
    """Three make_train_step steps (lr 1e-2 over a 40-step schedule) from
    a copy of params on dev: (params, losses, first moments) on the CPU.
    tf32: run the products with TF32 on (the fault the check must catch)."""
    from magicdec_tpu_torch import train

    p = _to(copy.deepcopy(params), dev)
    opt = train.make_optimizer(1e-2, 40)
    step = train.make_train_step(cfg, opt)
    state = opt.init(train.leaves_of(p))
    losses = []
    with train.highest_precision():
        if tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
        for toks in batches:
            p, state, loss = step(p, state, toks.to(dev))
            losses.append(float(loss))
    return ([t.detach().cpu() for t in train.leaves_of(p)], losses,
            [m.cpu() for m in state["mu"]])


def train_card_vs_cpu(torch, dev):
    """Three training steps of the small f32 model on the card and on the
    CPU, held within STEP_*_TOL; the card with TF32 on must fail them."""
    from magicdec_tpu_torch import train
    from magicdec_tpu_torch.data.converters import mixed_markov_dataset
    from magicdec_tpu_torch.models import llama

    cfg = _small_cfg().replace(tie_word_embeddings=True)
    params = llama.init_params(cfg, torch.float32, scale=0.1, seed=0,
                               device="cpu")
    p0 = train.leaves_of(params)
    batches = [torch.from_numpy(mixed_markov_dataset(
        seq_len=256, num_seqs=4, vocab_size=cfg.vocab_size, seed=20 + i))
        for i in range(3)]
    cpu = _three_steps(torch, "cpu", cfg, params, batches)

    def errors(run):
        got, losses, mu = run
        return dict(
            loss=max(abs(a - b) / abs(b) for a, b in zip(losses, cpu[1])),
            mu=max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(mu, cpu[2])),
            params=max(float((a - b).abs().mean() / (b - s).abs().mean())
                       for a, b, s in zip(got, cpu[0], p0)))

    def holds(e):
        return (e["loss"] <= STEP_LOSS_TOL and e["mu"] <= STEP_MU_TOL
                and e["params"] <= STEP_PARAM_TOL)

    card = errors(_three_steps(torch, dev, cfg, params, batches))
    tf32 = errors(_three_steps(torch, dev, cfg, params, batches, tf32=True))
    if torch.backends.cuda.matmul.allow_tf32:
        fail("train_card_vs_cpu: TF32 left on after the check")
    if not holds(card):
        fail(f"training on the card vs the CPU: {card}")
    if holds(tf32):
        fail(f"training with TF32 on passed the card-vs-CPU check: {tf32}")
    line(phase="train_card_vs_cpu", model="small f32 (2 layers, dim 256, "
         "tied)", steps=3, batch=4, seq=256, errors=card, errors_tf32=tf32,
         tol={"loss": STEP_LOSS_TOL, "mu": STEP_MU_TOL,
              "params": STEP_PARAM_TOL})


def trained(torch, dev, random_tok_s, steps=TRAIN_STEPS,
            glide_steps=GLIDE_STEPS):
    """BENCH_MODEL trained at full width on the card (bench.py's protocol,
    `steps` steps), its bf16 checkpoint saved and loaded bit for bit, then
    AR and SnapKV (budget 1024 and full) on held-out prompts with the
    trained weights, a GliDe block trained against the frozen target for
    `glide_steps` steps and its linear rounds. random_tok_s: the main
    path's random-weight tok/s, printed beside (None when not run). Returns
    the launch counts of the engine runs and of train_glide."""
    import tempfile

    from magicdec_tpu_torch import train
    from magicdec_tpu_torch.checkpoint.store import (flatten_params,
                                                     load_params, save_params)
    from magicdec_tpu_torch.data.converters import mixed_markov_dataset
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.glide_engine import GlideEngine
    from magicdec_tpu_torch.models.config import ModelArgs

    cfg = ModelArgs(**BENCH_MODEL)
    L = cfg.n_layer
    t = time.perf_counter()
    data = mixed_markov_dataset(seq_len=TRAIN_SEQ, num_seqs=TRAIN_SEQS,
                                seed=TRAIN_SEED)
    corpus_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    history = []
    # plain ops and cuBLAS only: the trainer launches none of the kernels
    (params, loss), _, train_s = _drive(
        torch, "train", lambda: train.train(
            cfg, data, steps=steps, batch=TRAIN_BATCH, lr=TRAIN_LR,
            seed=TRAIN_SEED, device=dev, history=history),
        lambda r: _zero())
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in history]
    if not all(x == x and abs(x) < float("inf") for x in losses):
        fail("trained: a training loss is not finite")
    if loss >= TRAINED_LOSS_MAX:
        fail(f"trained: final loss {loss} >= {TRAINED_LOSS_MAX} nats")
    del data
    ms_step = 1e3 * train_s / steps

    # the bf16 checkpoint, written and read back bit for bit
    p16 = train.cast_params(params, torch.bfloat16)
    del params
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "bench_model.npz")
        save_params(path, p16)
        back = load_params(path, device=dev)
    want, got = flatten_params(p16), flatten_params(back)
    if (back["output"] is not None or list(got) != list(want)
            or not all(got[k].dtype == torch.bfloat16 and torch.equal(
                got[k].view(torch.int16), want[k].view(torch.int16))
                for k in want)):
        fail("trained: the bf16 checkpoint did not round-trip bit for bit")
    p16 = back

    # held-out prompts: AR, SnapKV at budget 1024 and at full budget
    prompt = mixed_markov_dataset(seq_len=P, num_seqs=B, seed=HELD_OUT_SEED)
    runs, total = {}, _zero()
    for name, spec, budget in (("ar", None, 0), ("snapkv", "snapkv", BUDGET),
                               ("snapkv_full", "snapkv", P)):
        runs[name] = _spec_run(torch, cfg, p16, prompt, name, spec, budget)
        total = _add(total, runs[name]["launches"])
    ar = runs["ar"]["out"]
    for name in ("snapkv", "snapkv_full"):
        _check_stream(torch, f"trained {name}", runs[name]["out"],
                      runs[name]["counts"], ar, cfg.vocab_size)
    if runs["snapkv_full"]["stats"].acceptance_rate != 1.0:
        fail(f"trained snapkv_full: acceptance "
             f"{runs['snapkv_full']['stats'].acceptance_rate} != 1.0")

    # the GliDe block against the frozen trained target
    gdata = mixed_markov_dataset(seq_len=GLIDE_SEQ, num_seqs=GLIDE_SEQS,
                                 seed=TRAIN_SEED)
    ghist = []
    (gp, gloss), glaunch, glide_s = _drive(
        torch, "train_glide", lambda: train.train_glide(
            p16, cfg, gdata, steps=glide_steps, batch=TRAIN_BATCH,
            lr=TRAIN_LR, device=dev, history=ghist),
        lambda r: dict(_zero(), flash_prefill=L * glide_steps))
    glosses = [float(x) for x in ghist]
    if not gloss < 0.9 * glosses[0]:
        fail(f"train_glide: the loss did not fall ({glosses[0]} -> {gloss})")
    total = _add(total, glaunch)
    gp16 = train.cast_params(gp, torch.bfloat16)
    del gp, gdata

    def go_glide():
        return GlideEngine(Engine(cfg, p16, batch_size=B, max_len=MAX_LEN),
                           gp16).generate(prompt, NEW, gamma=GAMMA)

    (gout, gcounts, gstats), used, gseconds = _drive(
        torch, "trained glide linear", go_glide,
        _glide_expect(L, P // 128, None))
    _check_stream(torch, "trained glide linear", gout, gcounts, ar,
                  cfg.vocab_size)
    total = _add(total, used)

    def rate(s):
        return s.generated_tokens / s.wall_time_s

    half = steps // 2
    line(phase="trained", model="BENCH_MODEL (bench.py:57-59)",
         protocol={"corpus": f"mixed_markov_dataset(seq_len={TRAIN_SEQ}, "
                   f"num_seqs={TRAIN_SEQS}, seed={TRAIN_SEED})",
                   "batch": TRAIN_BATCH, "lr": TRAIN_LR, "dtype": "float32",
                   "remat": True, "tf32": False, "steps": steps,
                   "protocol_steps": PROTOCOL_STEPS},
         loss={"step_0": losses[0], f"step_{half}": losses[half],
               f"step_{steps}": loss},
         loss_every_tenth={i: losses[i] for i in range(
             0, steps, max(steps // 10, 1))},
         ms_per_step=ms_step,
         tokens_per_s=steps * TRAIN_BATCH * (TRAIN_SEQ - 1) / train_s,
         peak_memory_gb=peak / 2 ** 30, corpus_s=corpus_s, train_s=train_s,
         projected_protocol_s=corpus_s + PROTOCOL_STEPS * ms_step / 1e3,
         checkpoint="bf16 save_params/load_params bit-equal",
         held_out=f"mixed_markov_dataset(seq_len={P}, num_seqs={B}, "
                  f"seed={HELD_OUT_SEED})", B=B, P=P, new_tokens=NEW,
         gamma=GAMMA,
         acceptance={"snapkv_1024": runs["snapkv"]["stats"].acceptance_rate,
                     "snapkv_full": 1.0,
                     "glide_linear": gstats.acceptance_rate},
         rounds={"snapkv_1024": runs["snapkv"]["stats"].rounds,
                 "glide_linear": gstats.rounds},
         tok_s={"ar": rate(runs["ar"]["stats"]),
                "snapkv_1024": rate(runs["snapkv"]["stats"]),
                "snapkv_full": rate(runs["snapkv_full"]["stats"]),
                "glide_linear": rate(gstats)},
         random_weights_tok_s_llama_3_2_1b=random_tok_s,
         glide={"corpus": f"mixed_markov_dataset(seq_len={GLIDE_SEQ}, "
                f"num_seqs={GLIDE_SEQS}, seed={TRAIN_SEED})",
                "steps": glide_steps, "loss_first": glosses[0],
                "loss_last": gloss, "train_s": glide_s,
                "ms_per_step": 1e3 * glide_s / glide_steps,
                "flash_prefill_launches": glaunch["flash_prefill"]},
         launches={k: {n: c for n, c in r["launches"].items() if c}
                   for k, r in runs.items()},
         invariant1=True, invariant2=True)
    del p16, gp16
    torch.cuda.empty_cache()
    return total


def llama8b(torch, dev, profile_steps=8, profile_rounds=2):
    """The head_dim-128 path at full width: llama-3.1-8b (32 layers, dim
    4096, 32/8 heads, head_dim 128, FFN 14336, vocab 128256) with random
    bf16 weights from a seeded torch.Generator (seed 0, scale 0.3; 16 GB),
    B=8, P=4096, 64 new tokens, gamma 6, through the main path's Engine: AR,
    SnapKV at budget 1024 and at full budget, StreamingLLM at full budget,
    Quest at budget 1024 (the masked kernel and page_gather), RetroInfer at
    budget 1024 (page_gather_single and centroid_scores) and a greedy GliDe
    tree (2,2) generation with a random glide block (the return_lse forms).
    Every SnapKV, StreamingLLM, Quest and RetroInfer stream must equal the
    AR stream, the full
    budgets must accept exactly 1.0 and each run's launch counts (zeroed
    before it) must be those its path implies; the tree stream's share
    matching AR before a divergence is printed. Then the step profile of an
    AR step and of a SnapKV round. Returns the runs' summed launch counts
    (the launches of the head_dim-128 kernel entries) and what
    tensor_parallel compares with, at its depth (the first TP8B_LAYERS
    layers of the same weights): the AR stream of TP_NEW tokens and its
    first decode step's logits [B, V] (f32, on the host), plain and under
    _TpRounding."""
    import numpy as np

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.glide_engine import GlideEngine, SpecTree
    from magicdec_tpu_torch.engine.spec import (_eot_array,
                                                generate_autoregressive,
                                                snapkv_round)
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.models.glide import init_glide_params

    cfg = ModelArgs.from_name(MODEL_OF_D[128])
    if cfg.head_dim != 128:
        fail(f"{MODEL_OF_D[128]}: head_dim {cfg.head_dim}, not 128")
    L, chunks = cfg.n_layer, P // 128
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, seed=0,
                               device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, P))
    runs, total = {}, _zero()
    for name, spec, budget in (("ar", None, 0), ("snapkv", "snapkv", BUDGET),
                               ("snapkv_full", "snapkv", P),
                               ("streaming_full", "streaming", STREAM_FULL),
                               ("quest", "quest", BUDGET),
                               ("retro", "retro", BUDGET)):
        runs[name] = _spec_run(torch, cfg, params, prompt, name, spec, budget)
        total = _add(total, runs[name]["launches"])
    ar = runs["ar"]["out"]
    for name in ("snapkv", "snapkv_full", "streaming_full", "quest", "retro"):
        _check_stream(torch, f"llama8b {name}", runs[name]["out"],
                      runs[name]["counts"], ar, cfg.vocab_size)
    for name in ("snapkv_full", "streaming_full"):
        acc = runs[name]["stats"].acceptance_rate
        if acc != 1.0:
            fail(f"llama8b {name}: full-budget acceptance {acc} != 1.0 "
                 f"(invariant 2)")
    # tensor_parallel's references, at its depth (the first TP8B_LAYERS
    # layers): the AR stream of TP_NEW tokens and its first decode step's
    # logits, plain and with the row-parallel partials rounded as tp=2
    # rounds them
    first_logits = {}
    cut_cfg = cfg.replace(n_layer=TP8B_LAYERS)
    cut = _first_layers(params, TP8B_LAYERS)
    for name in ("plain", "tp_rounding"):
        # the tp world's route: tp forwards never run the fused block
        with (_TpRounding(llama, cfg.dim) if name == "tp_rounding"
              else contextlib.nullcontext()), _fused_mode(llama, "off"):
            with _FirstDecodeLogits(llama) as first:
                out, _ = generate_autoregressive(
                    Engine(cut_cfg, cut, batch_size=B, max_len=MAX_LEN),
                    prompt, TP_NEW)
        first_logits[name] = first.logits
        if name == "plain":
            tp_ar = out.cpu()
        torch.cuda.empty_cache()
    del cut

    tree = SpecTree((2, 2))
    gp = init_glide_params(cfg, torch.bfloat16, scale=GLIDE_SCALE,
                           seed=GLIDE_SEED, device=dev)

    def go_tree():
        return GlideEngine(Engine(cfg, params, batch_size=B, max_len=MAX_LEN),
                           gp).generate(prompt, NEW, gamma=GAMMA, tree=tree)

    (out, counts, stats), used, seconds = _drive(
        torch, "llama8b glide tree_2_2", go_tree, _glide_expect(L, chunks, tree))
    if out.min() < 0 or out.max() >= cfg.vocab_size:
        fail("llama8b glide tree_2_2: token ids out of range")
    runs["glide_tree_2_2"] = dict(out=out.cpu(), counts=counts.cpu(),
                                  stats=stats, total_s=seconds, launches=used)
    total = _add(total, used)
    share = _prefix_share(torch, out, counts, ar)
    del gp
    torch.cuda.empty_cache()

    # the step profile: an AR step and a SnapKV round at budget 1024
    saved = _counts()
    prof = {}
    eng = Engine(cfg, params, batch_size=B, max_len=MAX_LEN)
    state = {"tok": eng.encode(prompt)}

    def ar_step():
        state["tok"] = eng.inference(state["tok"])

    prof["ar_step"] = _profile(torch, ar_step, profile_steps)
    del eng, state
    torch.cuda.empty_cache()
    eng = Engine(cfg, params, batch_size=B, max_len=MAX_LEN, spec="snapkv",
                 draft_budget=BUDGET, window_size=WINDOW)
    state = {"buf": eng.encode(prompt),
             "gen": torch.zeros(B, dtype=torch.int32, device=dev)}
    output = torch.zeros((B, NEW + GAMMA + 3), dtype=torch.int32, device=dev)
    eot = _eot_array((), dev)

    def one_round():
        state["buf"], state["gen"], _ = snapkv_round(
            params, cfg, eng.cache, eng.draft, state["buf"], output,
            state["gen"], eot, GAMMA)

    prof["snapkv_round"] = _profile(torch, one_round, profile_rounds)
    _set_counts(saved)
    del eng, state, params
    torch.cuda.empty_cache()

    def rate(r):
        return r["stats"].generated_tokens / r["stats"].wall_time_s

    spec_runs = [k for k in runs if k != "ar"]
    line(phase="llama8b", model=MODEL_OF_D[128], dtype="bfloat16",
         head_dim=cfg.head_dim, layers=L, dim=cfg.dim, B=B, P=P,
         new_tokens=NEW, gamma=GAMMA, budget=BUDGET,
         streaming_full_budget=STREAM_FULL, init_s=init_s,
         tok_s={k: rate(r) for k, r in runs.items()},
         acceptance={k: runs[k]["stats"].acceptance_rate for k in spec_runs},
         rounds={k: runs[k]["stats"].rounds for k in spec_runs},
         run_s={k: r["total_s"] for k, r in runs.items()},
         decode_s={k: r["stats"].wall_time_s for k, r in runs.items()},
         launches={k: r["launches"] for k, r in runs.items()},
         tree_share_matching_ar_before_divergence=share,
         step_profile=prof, invariant1=True, invariant2=True)
    return total, dict(ar=tp_ar, logits=first_logits)


# ---------------------------------------------------------------------------
# phases 12e-12g: tensor parallelism, its per-shard kernel forms
# ---------------------------------------------------------------------------

TP = 2                      # two ranks share the one card over gloo
TP_NEW = 16                 # new tokens a tp run (the time two ranks take)
# tensor_parallel's depth: llama-3.1-8b's first 16 of 32 layers, so the
# script keeps to its time with the llama-3.2-1b worlds of tp_1b and dp_tp
# (PERF.md, the findings on data parallelism); every width is the model's
TP8B_LAYERS = 16
TP_PATHS = (("ar", None, 0), ("snapkv", "snapkv", BUDGET),
            ("snapkv_full", "snapkv", P),
            ("streaming_full", "streaming", STREAM_FULL),
            ("quest", "quest", BUDGET), ("retro", "retro", BUDGET))
NCCL_NEW = 8
RENDEZVOUS = ROOT / ".rendezvous"


class _TpRounding:
    """Within it, the model's row-parallel products (wo and w_down: the
    2-D weights with `dim` columns) run on one card as TP tp=2 ranks run
    them: K cut in two contiguous halves, each half's product rounded to
    the weights' dtype, the halves added (the all-reduce of two values);
    quantized weights are cut as the ranks hold them, the column-parallel
    ones too (_quantized).
    The other products and the attention are the same arithmetic at tp=1
    and tp=2, so llama8b's first decode step under it must give the tp=2
    world's logits bit for bit. Against plain tp=1 they differ by that
    re-rounding alone, which random weights amplify layer by layer (after
    32 layers of llama-3.1-8b the difference is as large as the logits:
    PERF.md, the tensor-parallelism findings), so no bf16 limit against
    plain tp=1 would tell a right tp run from a wrong one."""

    def __init__(self, llama, dim):
        self.llama, self.dim, self.orig = llama, dim, llama.qmatmul
        self.shards = {}

    def _quantized(self, x, w):
        """A quantized product (int8 or int4, one layer) as the tp ranks run
        it: each rank's shard cut by parallel/sharding as the Engine cuts it
        (int4_matmul then plans its K splits at the shard's K and N/2), the
        row-parallel outputs (a `dim`-wide output) added, the
        column-parallel ones concatenated."""
        import torch

        from magicdec_tpu_torch.parallel import sharding
        from magicdec_tpu_torch.quant.int8 import Int4ColWeight

        int8 = isinstance(w, dict)
        out = tuple(w["s"].shape[1:]) if int8 else tuple(w.out_shape)
        row = out == (self.dim,)
        K = x.shape[-1]
        key = (w["qT"] if int8 else w.q4).data_ptr()
        if key not in self.shards:
            whole = ({k: t[None] for k, t in w.items()} if int8
                     else Int4ColWeight(w.q4[None], w.s4[None], w.out_shape))
            cut = sharding._shard_int8 if int8 else sharding._shard_int4
            self.shards[key] = [cut(whole, "wo" if row else "wqkv",
                                    K if row else out[-1],
                                    sharding.Mesh(tp=TP, rank=r,
                                                  backend="gloo",
                                                  device=x.device))
                                for r in range(TP)]
        parts = []
        for r, sh in enumerate(self.shards[key]):
            sh = {k: t[0] for k, t in sh.items()} if int8 else sh[0]
            xr = x[:, r * K // TP:(r + 1) * K // TP].contiguous() if row else x
            parts.append(self.orig(xr, sh))
        return parts[0] + parts[1] if row else torch.cat(parts, dim=-1)

    def _qmatmul(self, x, w):
        from magicdec_tpu_torch.quant.int8 import Int4ColWeight
        if isinstance(w, (dict, Int4ColWeight)):
            return self._quantized(x, w)
        if w.dim() == 2 and w.shape[1] == self.dim:
            K = w.shape[0] // TP
            return (self.orig(x[:, :K].contiguous(), w[:K].contiguous())
                    + self.orig(x[:, K:].contiguous(), w[K:].contiguous()))
        return self.orig(x, w)

    def __enter__(self):
        self.llama.qmatmul = self._qmatmul

    def __exit__(self, *exc):
        self.llama.qmatmul = self.orig


class _FirstDecodeLogits:
    """Within it, the logits of the first forward that feeds one token a
    sequence (an AR run's first decode step) are kept in .logits [B, V]
    (f32, on the host); nothing else changes."""

    def __init__(self, llama):
        self.llama, self.orig, self.logits = llama, llama.forward, None

    def _forward(self, params, config, tokens, *args, **kw):
        out = self.orig(params, config, tokens, *args, **kw)
        if self.logits is None and tokens.shape[1] == 1:
            self.logits = out[:, 0].float().cpu()
        return out

    def __enter__(self):
        self.llama.forward = self._forward
        return self

    def __exit__(self, *exc):
        self.llama.forward = self.orig


def _tp_engine_kw(mesh):
    return dict(batch_size=B, max_len=MAX_LEN, window_size=WINDOW,
                sink_size=SINK, draft_headroom=STREAM_HEADROOM,
                latest_k=QUEST_TAIL, quest_page=QUEST_PAGE,
                retro_cap=RETRO_CAP, mesh=mesh)


def tp_rank(mesh, prompt):
    """One rank of the tensor_parallel world: llama-3.1-8b's shard of this
    rank (drawn a layer at a time from the seeded stream of init_params,
    seed 0, scale 0.3, bf16; its first TP8B_LAYERS layers kept), the paths of TP_PATHS and the asymmetric
    two-model SD (the rank's target shard; a 2-layer draft of the same
    widths, seed 1, whole on every rank), each with its launch counts
    (zeroed before it) held to what the path implies on this rank, and the
    AR run's first decode step's logits. Returns numpy results."""
    import torch

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.longspec import LongSpecEngine
    from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                                generate_selfspec)
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelArgs.from_name(MODEL_OF_D[128])
    kw = _tp_engine_kw(mesh)
    t0 = time.perf_counter()
    params = _first_layers(sharding.init_sharded_params(
        cfg, mesh, torch.bfloat16, scale=0.3, seed=0), TP8B_LAYERS, copy=True)
    cfg = cfg.replace(n_layer=TP8B_LAYERS)
    L, chunks = cfg.n_layer, P // 128
    torch.cuda.synchronize()
    res = dict(rank=mesh.rank, backend=mesh.backend,
               init_s=time.perf_counter() - t0,
               params_gb=sum(t.numel() * t.element_size() for t in
                             [params["tok_embeddings"], params["output"],
                              *params["layers"].values()]) / 1e9, runs={})

    def keep(name, result, used, seconds):
        out, counts, stats = result
        res["runs"][name] = dict(
            out=out.cpu().numpy(), counts=counts.cpu().numpy(),
            acceptance=stats.acceptance_rate, rounds=stats.rounds,
            tok_s=stats.generated_tokens / stats.wall_time_s,
            decode_s=stats.wall_time_s, run_s=seconds, launches=used)

    for name, spec, budget in TP_PATHS:
        def go():
            eng = Engine(cfg, params, spec=spec, draft_budget=budget, **kw)
            if spec is None:
                with _FirstDecodeLogits(llama) as first:
                    out, stats = generate_autoregressive(eng, prompt, TP_NEW)
                res["logits"] = first.logits.numpy()
                return out, torch.full((B,), TP_NEW, dtype=torch.int32), stats
            return generate_selfspec(eng, prompt, GAMMA, TP_NEW)

        keep(name, *_drive(torch, f"tp rank {mesh.rank} {name}", go,
                           _path_launches(L, spec, TP_NEW, sharded=True)))

    small = cfg.replace(n_layer=DRAFT_LAYERS)
    sparams = llama.init_params(small, torch.bfloat16, scale=0.3, seed=1,
                                device=mesh.device)

    def go_long():
        draft = Engine(small, sparams, replicate_tp=True, **kw)
        return LongSpecEngine(Engine(cfg, params, **kw), draft).generate(
            prompt, GAMMA, TP_NEW)

    def expect_long(result):
        r = result[-1].rounds
        out = dict(_zero(), flash_prefill=(L + DRAFT_LAYERS) * chunks,
                   flash_decode_stacked=(L + DRAFT_LAYERS * GAMMA) * r,
                   flash_prefill_sharded=L * chunks,
                   flash_decode_stacked_sharded=L * r,
                   **_fused_pair(DRAFT_LAYERS * GAMMA * r))
        return out

    keep("longspec_small_full", *_drive(
        torch, f"tp rank {mesh.rank} longspec", go_long, expect_long))
    del sparams

    res["peak_gb"] = torch.cuda.max_memory_allocated(mesh.device) / 1e9
    return res


def tensor_parallel(torch, dev, ref):
    """llama-3.1-8b at full width (its first TP8B_LAYERS layers) in a world
    of TP=2 ranks on the one card
    (gloo, CUDA tensors; each rank a process with its own shard), B=8,
    P=4096, TP_NEW new tokens, gamma 6: AR, SnapKV 1024 and full budget,
    StreamingLLM full budget, Quest 1024, RetroInfer 1024 and two-model SD
    with a replicated 2-layer draft (tp_rank). Both ranks must return the
    same streams and logits; every speculative stream must equal the tp AR
    stream, the full budgets accept exactly 1.0, each rank's launch counts
    are held in the rank; the first decode step's logits must be bit-equal
    to llama8b's under _TpRounding (tp=1 with tp=2's rounding of the
    row-parallel partials), and their distance to plain tp=1's and the
    share of the tp AR stream equal to the tp=1 stream are printed (the
    re-rounding grows through the layers; see _TpRounding). Returns the
    launch counts summed over the ranks and runs."""
    import numpy as np

    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.parallel.launch import run_world

    cfg = ModelArgs.from_name(MODEL_OF_D[128])
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, P))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    parent_gb = torch.cuda.memory_reserved(dev) / 1e9
    RENDEZVOUS.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    ranks = run_world(tp_rank, tp=TP, backend="gloo", devices=[dev] * TP,
                      args=(prompt,), rendezvous_dir=str(RENDEZVOUS),
                      timeout_s=900)
    world_s = time.perf_counter() - t0
    parent_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    r0 = ranks[0]
    for other in ranks[1:]:
        if not np.array_equal(other["logits"], r0["logits"]):
            fail("tensor_parallel: the ranks' logits differ")
        for name, run in r0["runs"].items():
            if not np.array_equal(other["runs"][name]["out"], run["out"]):
                fail(f"tensor_parallel {name}: the ranks' streams differ")
    runs = r0["runs"]
    ar = runs["ar"]["out"]
    for name, run in runs.items():
        if name != "ar":
            _check_stream(torch, f"tensor_parallel {name}", run["out"],
                          run["counts"], ar, cfg.vocab_size, new=TP_NEW)
    for name in ("snapkv_full", "streaming_full"):
        if runs[name]["acceptance"] != 1.0:
            fail(f"tensor_parallel {name}: full-budget acceptance "
                 f"{runs[name]['acceptance']} != 1.0 (invariant 2)")
    if not np.array_equal(r0["logits"], ref["logits"]["tp_rounding"].numpy()):
        fail("tensor_parallel: the first decode step's logits are not those "
             "of tp=1 with the row-parallel partials rounded as tp=2 rounds "
             "them")
    want = ref["logits"]["plain"].numpy()
    err = float(np.abs(r0["logits"] - want).max())
    scale = float(np.abs(want).max())
    tp1 = ref["ar"].numpy()[:, :TP_NEW]
    share = float((ar[:, :TP_NEW] == tp1).mean())
    total = _zero()
    for rank in ranks:
        for run in rank["runs"].values():
            total = _add(total, run["launches"])
    line(phase="tensor_parallel", model=MODEL_OF_D[128], dtype="bfloat16",
         layers=TP8B_LAYERS, layers_cut_from=cfg.n_layer, tp=TP,
         backend="gloo", device_per_rank=[str(dev)] * TP,
         note="two ranks time-share one card over gloo: no deployment "
              "tok/s", B=B, P=P, new_tokens=TP_NEW, gamma=GAMMA,
         budget=BUDGET, draft_layers=DRAFT_LAYERS, world_s=world_s,
         init_s=[r["init_s"] for r in ranks],
         params_gb_per_rank=[r["params_gb"] for r in ranks],
         peak_gb_per_rank=[r["peak_gb"] for r in ranks],
         parent_reserved_gb=parent_gb, parent_peak_gb=parent_peak_gb,
         tok_s={k: r["tok_s"] for k, r in runs.items()},
         acceptance={k: r["acceptance"] for k, r in runs.items()
                     if k != "ar"},
         rounds={k: r["rounds"] for k, r in runs.items() if k != "ar"},
         run_s={k: r["run_s"] for k, r in runs.items()},
         decode_s={k: r["decode_s"] for k, r in runs.items()},
         launches_rank0={k: {n: c for n, c in r["launches"].items() if c}
                         for k, r in runs.items()},
         first_step_logits=dict(
             bit_equal_to_tp1_with_tp_rounding=True,
             vs_plain_tp1=dict(max_abs_err=err, max_abs_ref=scale,
                               rel=err / scale)),
         ar_share_equal_to_tp1=share, invariant1=True, invariant2=True)
    return total


def nccl_rank(mesh, prompt):
    """The NCCL world of one: an all-reduce through the communicator, then
    AR on llama-3.2-1b (seed 0) with the mesh and without it."""
    import torch
    import torch.distributed as dist

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import generate_autoregressive
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs

    torch.backends.cuda.matmul.allow_tf32 = False
    ones = torch.ones(4, device=mesh.device)
    dist.all_reduce(ones, group=mesh.group)
    cfg = ModelArgs.from_name(MODEL_OF_D[64])
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, seed=0,
                               device=mesh.device)
    outs = {}
    for name, m in (("mesh", mesh), ("plain", None)):
        eng = Engine(cfg, params, batch_size=B, max_len=MAX_LEN, mesh=m,
                     device=mesh.device)
        outs[name] = generate_autoregressive(eng, prompt,
                                             NCCL_NEW)[0].cpu().numpy()
    return dict(backend=mesh.backend, tp=mesh.tp,
                all_reduce=ones.cpu().tolist(), **outs)


def nccl_world_of_one(torch, dev):
    """One rank with the nccl backend: its AR stream on llama-3.2-1b
    (NCCL_NEW tokens) must be bit-equal to the mesh=None stream."""
    import numpy as np

    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.parallel.launch import run_world

    vocab = ModelArgs.from_name(MODEL_OF_D[64]).vocab_size
    prompt = np.random.default_rng(7).integers(0, vocab, (B, P))
    RENDEZVOUS.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    (r,) = run_world(nccl_rank, tp=1, backend="nccl", devices=[dev],
                     args=(prompt,), rendezvous_dir=str(RENDEZVOUS),
                     timeout_s=600)
    if r["backend"] != "nccl" or r["all_reduce"] != [1.0] * 4:
        fail(f"nccl_world_of_one: backend {r['backend']}, all_reduce "
             f"{r['all_reduce']}")
    if not np.array_equal(r["mesh"], r["plain"]):
        fail("nccl_world_of_one: the mesh stream differs from mesh=None's")
    line(phase="nccl_world_of_one", model=MODEL_OF_D[64], backend="nccl",
         tp=r["tp"], new_tokens=NCCL_NEW, seconds=time.perf_counter() - t0,
         stream_equal=True)


# ---------------------------------------------------------------------------
# phases 12j-12k: what tensor parallelism left out, at llama-3.2-1b full
# width: GliDe, SqueezedAttention and quantized weights under tp, and a
# dp x tp world with a sub-mesh
# ---------------------------------------------------------------------------

# the int4 products' shapes (K, N/2) a tp=2 rank of llama-3.2-1b holds
INT4_TP2_SHAPES = {"wqkv": (2048, 768), "wo": (1024, 1024),
                   "w_gate_up": (2048, 4096), "w_down": (4096, 1024)}


def _first_layers(params, n, copy=False):
    """The params of a model cut to its first n layers (the same weights,
    a view unless copy)."""
    return dict(params, layers={k: (v[:n].clone() if copy else v[:n])
                                for k, v in params["layers"].items()})


def _tp_expect(L, spec, chunks=None, mode=None):
    """_path_launches on a tp rank of a TP_NEW-token run with `chunks`
    prefill chunks (None: P's), and int4_matmul 4 L a forward (prefill
    chunks included) for int4 weights."""
    chunks = P // 128 if chunks is None else chunks
    new = TP_NEW

    def launches(result):
        want = _path_launches(L, spec, new, sharded=True)(result)
        want["flash_prefill"] = want["flash_prefill_sharded"] = L * chunks
        if mode == "int4":
            r = result[-1].rounds
            steps = new - 1 if spec is None else (GAMMA + 1) * r
            want["int4_matmul"] = 4 * L * (chunks + steps)
        return want
    return launches


def _glide_tp_expect(L, chunks, tree):
    """_glide_expect on a tp rank: the target's prefill and verify run
    through the per-shard forms (the tree verify's prefix part through
    flash_stacked_lse), the glide's own attention through the kernels."""
    base = _glide_expect(L, chunks, tree)

    def launches(result):
        want = dict(base(result), **_fused_pair(0))
        want["flash_prefill_sharded"] = L * chunks
        if tree is None:
            want["flash_decode_stacked_sharded"] = want["flash_decode_stacked"]
        else:
            want["flash_decode_stacked_lse_sharded"] = want[
                "flash_decode_stacked_lse"]
        return want
    return launches


def tp1b_rank(mesh, prompt):
    """One rank of the tp_1b world (tp=2): llama-3.2-1b's seeded bf16
    weights (seed 0, scale 0.3), cut by the Engine, run AR (keeping the
    first decode step's logits), SqueezedAttention 1024, GliDe linear and
    tree (2,2) with the glide phase's random block (cut by GlideEngine);
    in float32 with the prompt cut to GLIDE_F32_P, AR and the GliDe tree
    (2,2); then the weights quantized whole on the rank (int8, int4) and
    cut by the Engine: AR (logits kept), SnapKV 1024 and full budget. Each
    run's launch counts (zeroed before it) are held to what its path
    implies on this rank. Returns numpy results and the int4 shards' q4
    shapes."""
    import torch

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.glide_engine import GlideEngine, SpecTree
    from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                                generate_selfspec)
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.models.glide import init_glide_params
    from magicdec_tpu_torch.quant.int8 import quantize_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelArgs.from_name(MODEL_OF_D[64])
    L, chunks = cfg.n_layer, P // 128
    kw = _tp_engine_kw(mesh)
    dev = mesh.device
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, seed=0,
                               device=dev)
    res = dict(rank=mesh.rank, runs={}, logits={})
    tree = SpecTree((2, 2))

    def drive(name, go, expect):
        (out, counts, stats), used, seconds = _drive(
            torch, f"tp_1b rank {mesh.rank} {name}", go, expect)
        res["runs"][name] = dict(
            out=out.cpu().numpy(), counts=counts.cpu().numpy(),
            acceptance=stats.acceptance_rate, rounds=stats.rounds,
            tok_s=stats.generated_tokens / stats.wall_time_s,
            decode_s=stats.wall_time_s, run_s=seconds, launches=used)

    def ar(p, pr, logits=None, **ekw):
        def go():
            eng = Engine(cfg, p, **{**kw, **ekw})
            if logits == "int4":
                res["int4_q4_shapes"] = {
                    k: tuple(w.q4.shape[1:])
                    for k, w in eng.params["layers"].items()
                    if k in INT4_TP2_SHAPES}
            with _FirstDecodeLogits(llama) as first:
                out, stats = generate_autoregressive(eng, pr, TP_NEW)
            if logits:
                res["logits"][logits] = first.logits.numpy()
            return out, torch.full((B,), TP_NEW, dtype=torch.int32), stats
        return go

    def spec(p, mode, budget):
        return lambda: generate_selfspec(
            Engine(cfg, p, spec=mode, draft_budget=budget, **kw), prompt,
            GAMMA, TP_NEW)

    def glide(p, gp, pr, branching, **ekw):
        return lambda: GlideEngine(Engine(cfg, p, **{**kw, **ekw}), gp).generate(
            pr, TP_NEW, gamma=GAMMA,
            tree=None if branching is None else SpecTree(branching))

    drive("ar", ar(params, prompt, "bf16"), _tp_expect(L, None))
    drive("squeeze", spec(params, "squeeze", BUDGET), _tp_expect(L, "squeeze"))
    gp = init_glide_params(cfg, torch.bfloat16, scale=GLIDE_SCALE,
                           seed=GLIDE_SEED, device=dev)
    drive("glide_linear", glide(params, gp, prompt, None),
          _glide_tp_expect(L, chunks, None))
    drive("glide_tree_2_2", glide(params, gp, prompt, (2, 2)),
          _glide_tp_expect(L, chunks, tree))
    del gp
    p32 = _to(params, torch.float32)
    gp32 = init_glide_params(cfg, torch.float32, scale=GLIDE_SCALE,
                             seed=GLIDE_SEED, device=dev)
    pr32, c32 = prompt[:, :GLIDE_F32_P], GLIDE_F32_P // 128
    max_len = GLIDE_F32_P + TP_NEW + 2 * GAMMA + 16
    drive("f32_ar", ar(p32, pr32, max_len=max_len),
          _tp_expect(L, None, chunks=c32))
    drive("f32_glide_tree_2_2", glide(p32, gp32, pr32, (2, 2),
                                      max_len=max_len),
          _glide_tp_expect(L, c32, tree))
    del p32, gp32
    torch.cuda.empty_cache()
    for mode in ("int8", "int4"):
        q = quantize_params(params, mode)
        drive(f"{mode}_ar", ar(q, prompt, mode), _tp_expect(L, None,
                                                             mode=mode))
        drive(f"{mode}_snapkv", spec(q, "snapkv", BUDGET),
              _tp_expect(L, "snapkv", mode=mode))
        drive(f"{mode}_snapkv_full", spec(q, "snapkv", P),
              _tp_expect(L, "snapkv", mode=mode))
        del q
        torch.cuda.empty_cache()
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def _tp1_refs(torch, dev, prompt):
    """tp_1b's references on one card: llama-3.2-1b's first decode step's
    logits [B, V] with bf16, int8 and int4 weights under _TpRounding (tp=1
    with tp=2's cuts and roundings of the products)."""
    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import generate_autoregressive
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.quant.int8 import quantize_params

    cfg = ModelArgs.from_name(MODEL_OF_D[64])
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, seed=0,
                               device=dev)
    refs = {}
    for mode in ("bf16", "int8", "int4"):
        w = params if mode == "bf16" else quantize_params(params, mode)
        # unfused, as the tp ranks run (bf16: the fused block would skip
        # _TpRounding's products)
        with (_TpRounding(llama, cfg.dim), _fused_mode(llama, "off"),
              _FirstDecodeLogits(llama) as first):
            generate_autoregressive(Engine(cfg, w, batch_size=B,
                                           max_len=MAX_LEN), prompt, 2)
        refs[mode] = first.logits.numpy()
        del w
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return refs


def tp_1b(torch, dev):
    """What tensor parallelism left out, at llama-3.2-1b full width (B=8,
    P=4096, TP_NEW new tokens, gamma 6) in a world of TP=2 ranks on the one
    card (gloo): SqueezedAttention 1024, GliDe linear and tree (2,2), the
    float32 GliDe tree (2,2) at P=GLIDE_F32_P, int8 and int4 SnapKV 1024
    and full budget (tp1b_rank). The ranks' streams and logits must be
    equal; SqueezedAttention's and GliDe linear's streams must equal the
    tp AR stream, the float32 tree's the float32 tp AR stream, each
    quantized SnapKV stream its tp AR stream; the full budgets accept
    exactly 1.0; the first decode step's logits (bf16, int8, int4) are
    bit-equal to tp=1's under _TpRounding; the int4 shards' q4 are the
    tp=2 shard shapes, at which int4_matmul ran. The bf16 tree stream's
    share matching AR before a divergence is printed. Returns the launch
    counts summed over the ranks and runs, and the bf16 tp AR stream."""
    import numpy as np

    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.parallel.launch import run_world

    cfg = ModelArgs.from_name(MODEL_OF_D[64])
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P))
    t0 = time.perf_counter()
    refs = _tp1_refs(torch, dev, prompt)
    refs_s = time.perf_counter() - t0
    RENDEZVOUS.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    ranks = run_world(tp1b_rank, tp=TP, backend="gloo", devices=[dev] * TP,
                      args=(prompt,), rendezvous_dir=str(RENDEZVOUS),
                      timeout_s=900)
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    for other in ranks[1:]:
        for key, lg in r0["logits"].items():
            if not np.array_equal(other["logits"][key], lg):
                fail(f"tp_1b: the ranks' {key} logits differ")
        for name, run in r0["runs"].items():
            if not np.array_equal(other["runs"][name]["out"], run["out"]):
                fail(f"tp_1b {name}: the ranks' streams differ")
    runs = r0["runs"]
    against = {"squeeze": "ar", "glide_linear": "ar",
               "f32_glide_tree_2_2": "f32_ar", "int8_snapkv": "int8_ar",
               "int8_snapkv_full": "int8_ar", "int4_snapkv": "int4_ar",
               "int4_snapkv_full": "int4_ar"}
    for name, ar in against.items():
        _check_stream(torch, f"tp_1b {name}", runs[name]["out"],
                      runs[name]["counts"], runs[ar]["out"], cfg.vocab_size,
                      new=TP_NEW)
    for name in ("int8_snapkv_full", "int4_snapkv_full"):
        if runs[name]["acceptance"] != 1.0:
            fail(f"tp_1b {name}: full-budget acceptance "
                 f"{runs[name]['acceptance']} != 1.0 (invariant 2)")
    for mode, want in refs.items():
        if not np.array_equal(r0["logits"][mode], want):
            err = float(np.abs(r0["logits"][mode] - want).max())
            fail(f"tp_1b: the {mode} first decode step's logits are not "
                 f"those of tp=1 under _TpRounding (max abs diff {err})")
    for rank in ranks:
        if rank["int4_q4_shapes"] != INT4_TP2_SHAPES:
            fail(f"tp_1b: rank {rank['rank']}'s int4 shards hold q4 "
                 f"{rank['int4_q4_shapes']}, not {INT4_TP2_SHAPES}")
    tree = runs["glide_tree_2_2"]
    share = _prefix_share(torch, torch.as_tensor(tree["out"][:, :TP_NEW]),
                          np.minimum(tree["counts"], TP_NEW),
                          torch.as_tensor(runs["ar"]["out"]))
    total = _zero()
    for rank in ranks:
        for run in rank["runs"].values():
            total = _add(total, run["launches"])
    line(phase="tp_1b", model=MODEL_OF_D[64], dtype="bfloat16", tp=TP,
         backend="gloo", B=B, P=P, f32_P=GLIDE_F32_P, new_tokens=TP_NEW,
         gamma=GAMMA, budget=BUDGET, world_s=world_s, refs_s=refs_s,
         note="two ranks time-share one card over gloo: no deployment "
              "tok/s",
         peak_gb_per_rank=[r["peak_gb"] for r in ranks],
         int4_q4_shapes=r0["int4_q4_shapes"],
         tok_s={k: r["tok_s"] for k, r in runs.items()},
         acceptance={k: r["acceptance"] for k, r in runs.items()
                     if not k.endswith("ar")},
         rounds={k: r["rounds"] for k, r in runs.items()},
         run_s={k: r["run_s"] for k, r in runs.items()},
         decode_s={k: r["decode_s"] for k, r in runs.items()},
         launches_rank0={k: _nonzero(r["launches"]) for k, r in runs.items()},
         first_step_logits_bit_equal_to_tp1_with_tp_rounding=sorted(refs),
         glide_tree_share_matching_ar_before_divergence=share,
         invariant1=True, invariant2=True)
    return total, runs["ar"]["out"]


def dptp_rank(mesh, prompt):
    """One rank of the dp_tp world (dp=2 x tp=2, four ranks on the one
    card): llama-3.2-1b's seeded bf16 weights, each rank holding its tp
    shard and its dp block of B/2 rows; AR, SnapKV 1024 and full budget,
    StreamingLLM full budget, each with its launch counts held on this
    rank; then the sub-mesh make_mesh(dp=1, tp=2) (ranks 0-1; the others
    get None and run nothing on it) runs AR. Returns numpy results, every
    stream the whole batch's [B, N]."""
    import torch

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.spec import (generate_autoregressive,
                                                generate_selfspec)
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelArgs.from_name(MODEL_OF_D[64])
    L = cfg.n_layer
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, seed=0,
                               device=mesh.device)
    sub = sharding.make_mesh(dp=1, tp=TP, device=mesh.device)
    res = dict(layout=(mesh.dp, mesh.dp_rank, mesh.tp, mesh.rank),
               sub=None if sub is None else (sub.dp, sub.dp_rank, sub.tp,
                                             sub.rank), runs={})

    def run(name, m, spec, budget):
        def go():
            eng = Engine(cfg, params, spec=spec, draft_budget=budget,
                         **_tp_engine_kw(m))
            if spec is None:
                out, stats = generate_autoregressive(eng, prompt, TP_NEW)
                return out, torch.full((B,), TP_NEW, dtype=torch.int32), stats
            return generate_selfspec(eng, prompt, GAMMA, TP_NEW)

        (out, counts, stats), used, seconds = _drive(
            torch, f"dp_tp rank {mesh.dp_rank},{mesh.rank} {name}", go,
            _path_launches(L, spec, TP_NEW, sharded=True))
        res["runs"][name] = dict(
            out=out.cpu().numpy(), counts=counts.cpu().numpy(),
            acceptance=stats.acceptance_rate, rounds=stats.rounds,
            tok_s=stats.generated_tokens / stats.wall_time_s,
            decode_s=stats.wall_time_s, run_s=seconds, launches=used)

    for name, spec, budget in DP_TP_PATHS:
        run(name, mesh, spec, budget)
    if sub is not None:
        run("sub_ar", sub, None, 0)
    return res


# the dp_tp world's runs on its dp=2 x tp=2 mesh
DP_TP_PATHS = (("ar", None, 0), ("snapkv", "snapkv", BUDGET),
               ("snapkv_full", "snapkv", P),
               ("streaming_full", "streaming", STREAM_FULL))


def dp_tp(torch, dev, tp_ar):
    """llama-3.2-1b at full width (B=8, P=4096, TP_NEW new tokens, gamma
    6) in a world of four ranks on the one card (gloo) with a dp=2 x tp=2
    mesh (dptp_rank): AR, SnapKV 1024 and full budget, StreamingLLM full
    budget; every rank must return the same gathered [B, N] stream, the
    speculative streams equal the dp AR stream, the full budgets accept
    exactly 1.0; the share of rows equal to tp_1b's tp=2 AR stream is
    printed (a dp rank pads its B/2 rows to another row bucket than B
    rows, so bf16 rows may differ in low bits: models/llama.py). In the
    same world the sub-mesh make_mesh(dp=1, tp=2) is ranks 0-1 (ranks 2-3
    get None) and its AR stream must equal tp_1b's. Returns the launch
    counts summed over the ranks and runs."""
    import numpy as np

    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.parallel.launch import run_world

    cfg = ModelArgs.from_name(MODEL_OF_D[64])
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P))
    RENDEZVOUS.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    ranks = run_world(dptp_rank, tp=TP, dp=2, backend="gloo",
                      devices=[dev] * (2 * TP), args=(prompt,),
                      rendezvous_dir=str(RENDEZVOUS), timeout_s=900)
    world_s = time.perf_counter() - t0
    for r, rank in enumerate(ranks):
        if rank["layout"] != (2, r // TP, TP, r % TP):
            fail(f"dp_tp: rank {r} has the mesh layout {rank['layout']}")
        if rank["sub"] != ((1, 0, TP, r) if r < TP else None):
            fail(f"dp_tp: rank {r} has the sub-mesh layout {rank['sub']}")
    r0 = ranks[0]
    for rank in ranks[1:]:
        for name, run in rank["runs"].items():
            if not np.array_equal(run["out"], r0["runs"][name]["out"]):
                fail(f"dp_tp {name}: the ranks' gathered streams differ")
    runs = r0["runs"]
    for name, run in runs.items():
        if run["out"].shape[0] != B:
            fail(f"dp_tp {name}: a stream of {run['out'].shape[0]} rows, "
                 f"not the batch's {B}")
        if name not in ("ar", "sub_ar"):
            _check_stream(torch, f"dp_tp {name}", run["out"], run["counts"],
                          runs["ar"]["out"], cfg.vocab_size, new=TP_NEW)
    for name in ("snapkv_full", "streaming_full"):
        if runs[name]["acceptance"] != 1.0:
            fail(f"dp_tp {name}: full-budget acceptance "
                 f"{runs[name]['acceptance']} != 1.0 (invariant 2)")
    if not np.array_equal(runs["sub_ar"]["out"], tp_ar):
        fail("dp_tp: the sub-mesh's AR stream differs from tp_1b's")
    rows_equal = float((runs["ar"]["out"][:, :TP_NEW] == tp_ar[:, :TP_NEW])
                       .all(axis=1).mean())
    total = _zero()
    for rank in ranks:
        for run in rank["runs"].values():
            total = _add(total, run["launches"])
    line(phase="dp_tp", model=MODEL_OF_D[64], dtype="bfloat16", dp=2, tp=TP,
         world=2 * TP, backend="gloo", B=B, rows_per_dp_rank=B // 2, P=P,
         new_tokens=TP_NEW, gamma=GAMMA, budget=BUDGET, world_s=world_s,
         note="four ranks time-share one card over gloo: no deployment "
              "tok/s",
         layouts=[r["layout"] for r in ranks], sub=[r["sub"] for r in ranks],
         tok_s={k: r["tok_s"] for k, r in runs.items()},
         acceptance={k: r["acceptance"] for k, r in runs.items()
                     if not k.endswith("ar")},
         rounds={k: r["rounds"] for k, r in runs.items()},
         run_s={k: r["run_s"] for k, r in runs.items()},
         decode_s={k: r["decode_s"] for k, r in runs.items()},
         launches_rank0={k: _nonzero(r["launches"]) for k, r in runs.items()},
         ar_rows_equal_to_tp2_share=rows_equal, sub_mesh_ar_equals_tp2=True,
         invariant1=True, invariant2=True)
    return total


def _bit_equal(torch, got, want):
    """Whether two tensors hold the same bits (-0.0 and 0.0 differ)."""
    def bits(t):
        t = t.contiguous()
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return got.shape == want.shape and torch.equal(bits(got), bits(want))


def sharded_kernels(torch, dev, launches, L=16):
    """Each per-shard form of tensor parallelism at llama-3.1-8b's heads
    (Hq=32, Hkv=8, D=128, bf16; B=8) on the main path's shapes, cut into
    tp=2 and tp=4 head shards (each a contiguous copy of the rank's block):
    _flash_stacked at T=1 and T=7 (ragged: 130 to 4128 cached slots of
    4224),
    _flash_prefill_dispatch (the last 128-token chunk of P=4096),
    _flash_intervals (the StreamingLLM draft, 1088 slots, sink rows apart),
    _tail_attend (the masked form over the Quest round buffer, 70% of the
    top bits), page_gather_sharded (7 of 33 pages of 128 rows),
    page_gather_single_sharded (28 of 130 clusters of 64 rows),
    centroid_scores_sharded (130 f32 centroids) and flash_stacked_lse
    (the GliDe tree (2,2) verify's prefix part: ctx, m and l at T=7). The
    ranks' outputs
    concatenated must be bit-equal to the kernel's output on the whole
    tensors, and each rank's within its plain version's limit (the
    attention forms: fd.plain_f32_and_limit's; the gathers bit-exact;
    centroid_scores 1e-5 + 1e-5 |plain|; the lse form's m and l within
    fd.lse_limits). Then each form's device time at
    the tp=2 shard (rank 0), from a replayed CUDA graph, beside the kernel
    on the whole tensors at the same lengths, its plain version, its bound
    (the shard's bytes at 3.35 TB/s or its FLOPs at 989 TFLOP/s bf16, 67
    TFLOP/s f32 for centroid_scores, counting the slots each sequence
    reads) and one PyTorch call on the same shard (SDPA; index_select).
    `launches` are the counts of the tensor_parallel, tp_1b and dp_tp
    phases (every rank). Returns the kernels-line rows."""
    import torch.nn.functional as F

    from magicdec_tpu_torch.engine import attention_impls as impls
    from magicdec_tpu_torch.engine.retro import _tail_attend
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops import gemm_softmax as gs
    from magicdec_tpu_torch.ops import page_gather as pg
    from magicdec_tpu_torch.ops.attention import decode_valid_upto
    from magicdec_tpu_torch.parallel.sharding import Mesh

    t_start = time.perf_counter()
    Hq, Hkv, D, S = 32, 8, 128, 4224
    HD, item = Hkv * D, 2
    saved = _counts()
    g = torch.Generator(device=dev).manual_seed(12)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def block(x, tp, r, axis):
        n = x.shape[axis] // tp
        return x.narrow(axis, r * n, n).contiguous()

    def mesh(tp, r):
        return Mesh(tp=tp, rank=r, backend="gloo", device=dev)

    k, v = rnd(L, B, S, HD), rnd(L, B, S, HD)
    lens = torch.tensor([P + 32, P + 31, P - 600, P + 32, 3000, P + 20, 130,
                         P], dtype=torch.int32, device=dev)
    pages = _gather_pages(torch, dev, S // QUEST_PAGE, QUEST_NS // QUEST_PAGE,
                          73)
    store = rnd(L, B, RETRO_C * 2 * RETRO_CAP, HD)
    clusters = _gather_pages(torch, dev, RETRO_C, RETRO_N, 74)
    cents = torch.randn((L, B, RETRO_C, HD), generator=g, device=dev) * 0.2
    kf = k[L - 1, :, :DRAFT_SLOTS].contiguous()
    vf = v[L - 1, :, :DRAFT_SLOTS].contiguous()
    sinks = k[0, :, :SINK].contiguous()
    a, lo, hi_s = _stream_rows(torch, dev, [1060] * B, 1, SINK)
    bk = k[:, :, :QUEST_R].contiguous()
    bv = v[:, :, :QUEST_R].contiguous()
    cm, ns, hi_q = _quest_rows(torch, dev, 1, seed=75, top_share=0.7, L=L)
    qs = {T: rnd(B, T, Hq, D) for T in (1, 7, 128)}
    valid = {T: decode_valid_upto(lens - T, T) for T in (1, 7)}
    valid[128] = decode_valid_upto(torch.full((B,), P - 128, dtype=torch.int32,
                                              device=dev), 128)

    def cview(c):           # [B, C, h*D] -> the kernel's [B, h, C, D] view
        return c.view(B, RETRO_C, -1, D).transpose(1, 2)

    # name -> (the form on a rank's shard, the kernel on the whole tensors,
    # the output axis the shards concatenate along, the plain check on a
    # shard: (ref f32, limit) or an exact output)
    def attention(form_call, kern, plain_limit):
        return form_call, kern, 2, plain_limit

    forms = {}
    for T in (1, 7):
        forms[f"flash_decode_stacked_sharded_T{T}"] = attention(
            lambda tp, r, l, T=T: impls._flash_stacked(
                block(qs[T], tp, r, 2), block(k, tp, r, 3),
                block(v, tp, r, 3), l, valid[T], mesh(tp, r)),
            lambda l, T=T: fd.flash_decode_stacked(qs[T], k, v, l, valid[T]),
            lambda tp, r, l, T=T: fd.plain_f32_and_limit(
                block(qs[T], tp, r, 2), block(k[l:l + 1], tp, r, 3),
                block(v[l:l + 1], tp, r, 3), 0, valid[T]))
    forms["flash_prefill_sharded"] = attention(
        lambda tp, r, l: impls._flash_prefill_dispatch(
            block(qs[128], tp, r, 2), block(k, tp, r, 3), block(v, tp, r, 3),
            l, valid[128], mesh(tp, r), s_cap=P),
        lambda l: fd.flash_prefill(qs[128], k, v, l, valid[128], s_cap=P),
        lambda tp, r, l: fd.plain_f32_and_limit(
            block(qs[128], tp, r, 2), block(k[l:l + 1], tp, r, 3),
            block(v[l:l + 1], tp, r, 3), 0, valid[128], s_cap=P))
    forms["flash_decode_intervals_sharded"] = attention(
        lambda tp, r, l: impls._flash_intervals(
            block(qs[1], tp, r, 2), block(kf, tp, r, 2), block(vf, tp, r, 2),
            a, lo, hi_s, mesh(tp, r), k_sink=block(sinks, tp, r, 2)),
        lambda l: fd.flash_decode_intervals(qs[1], kf, vf, a, lo, hi_s,
                                            k_sink=sinks),
        lambda tp, r, l: fd.intervals_plain_f32_and_limit(
            block(qs[1], tp, r, 2), block(kf, tp, r, 2), block(vf, tp, r, 2),
            a, lo, hi_s, block(sinks, tp, r, 2)))
    forms["flash_decode_stacked_masked_sharded"] = attention(
        lambda tp, r, l: _tail_attend(
            block(qs[1], tp, r, 2), block(bk, tp, r, 3), block(bv, tp, r, 3),
            cm, l, ns, hi_q, mesh(tp, r)),
        lambda l: fd.flash_decode_stacked_masked(qs[1], bk, bv, l, cm, ns, ns,
                                                 hi_q),
        lambda tp, r, l: fd.stacked_masked_plain_f32_and_limit(
            block(qs[1], tp, r, 2), block(bk, tp, r, 3), block(bv, tp, r, 3),
            l, cm, ns, ns, hi_q))
    forms["page_gather_sharded"] = (
        lambda tp, r, l: torch.stack(pg.page_gather_sharded(
            block(k, tp, r, 3), block(v, tp, r, 3), l, pages, QUEST_PAGE,
            mesh=mesh(tp, r))),
        lambda l: torch.stack(pg.page_gather(k, v, l, pages, QUEST_PAGE)),
        4,
        lambda tp, r, l: torch.stack(pg.page_gather_plain(
            block(k, tp, r, 3), block(v, tp, r, 3), l, pages, QUEST_PAGE)))
    forms["page_gather_single_sharded"] = (
        lambda tp, r, l: pg.page_gather_single_sharded(
            block(store, tp, r, 3), l, clusters, 2 * RETRO_CAP,
            mesh=mesh(tp, r)),
        lambda l: pg.page_gather_single(store, l, clusters, 2 * RETRO_CAP),
        3,
        lambda tp, r, l: pg.page_gather_single_plain(
            block(store, tp, r, 3), l, clusters, 2 * RETRO_CAP))

    def scores_plain(tp, r, l):
        ref = gs.centroid_scores_plain(block(qs[1], tp, r, 2),
                                       cview(block(cents[l], tp, r, 2)))
        return ref, 1e-5 + 1e-5 * ref.abs()

    forms["centroid_scores_sharded"] = (
        lambda tp, r, l: gs.centroid_scores_sharded(
            block(qs[1], tp, r, 2), cview(block(cents[l], tp, r, 2)),
            mesh=mesh(tp, r)),
        lambda l: gs.centroid_scores(qs[1], cview(cents[l])), 1, scores_plain)

    def lse_plain(tp, r, l):
        q, kk, vv = (block(qs[7], tp, r, 2), block(k[l:l + 1], tp, r, 3),
                     block(v[l:l + 1], tp, r, 3))
        want = fd.attention_plain_lse(q.float(), kk.float(), vv.float(), 0,
                                      valid[7])
        return ("lse", want) + fd.plain_f32_and_limit(q, kk, vv, 0, valid[7])

    # the GliDe tree (2,2) verify's prefix part: (ctx, m, l) at T=7
    forms["flash_decode_stacked_lse_sharded"] = attention(
        lambda tp, r, l: impls.flash_stacked_lse(
            block(qs[7], tp, r, 2), block(k, tp, r, 3), block(v, tp, r, 3),
            l, valid[7], mesh=mesh(tp, r)),
        lambda l: fd.flash_decode_stacked(qs[7], k, v, l, valid[7],
                                          return_lse=True),
        lse_plain)

    # the checks: layers 0 and L - 1
    errs, ratios = {}, {}
    for name, (form, kern, axis, plain) in forms.items():
        e, rt = {}, {}
        for l in (0, L - 1):
            whole = kern(l)
            for tp in (2, 4):
                outs = [form(tp, r, l) for r in range(tp)]
                parts = zip(*outs) if isinstance(whole, tuple) else [outs]
                wholes = whole if isinstance(whole, tuple) else [whole]
                if not all(_bit_equal(torch, torch.cat(p, dim=axis), w_)
                           for p, w_ in zip(parts, wholes)):
                    fail(f"sharded_kernels {name}: the tp={tp} shards "
                         f"concatenated are not the whole kernel's bits "
                         f"(layer {l})")
                for r, out in enumerate(outs):
                    ref = plain(tp, r, l)
                    what = f"{name} tp{tp} r{r} l{l}"
                    if isinstance(ref, tuple) and isinstance(ref[0], str):
                        e_, r_ = {}, {}
                        _hold_lse(torch, fd, what, out, ref[1], ref[2],
                                  ref[3], torch.bfloat16, e_, r_)
                        e[what], rt[what] = e_[what], max(r_[what].values())
                    elif isinstance(ref, tuple):
                        _check_out(torch, what, out, ref[0], ref[1], e, rt)
                    elif not _bit_equal(torch, out, ref):
                        fail(f"sharded_kernels {name}: tp={tp} rank {r} "
                             f"differs from its plain version (layer {l})")
        errs[name] = max(e.values(), default=0.0)
        ratios[name] = max(rt.values(), default=0.0)

    # the times at the tp=2 shard of rank 0, and of the kernel on the whole
    # tensors at the same lengths (the same work, all heads)
    tp = 2
    w = dict(q1=qs[1], q7=qs[7], q128=qs[128], k=k, v=v,
             kf=k[:, :, :DRAFT_SLOTS].contiguous(),
             vf=v[:, :, :DRAFT_SLOTS].contiguous(),
             sinks=k[:, :, :SINK].contiguous(), bk=bk, bv=bv, store=store,
             cents=cents)
    s = {name: block(x, tp, 0, 2 if name[0] == "q" else 3)
         for name, x in w.items()}
    m0, hkv, hq = mesh(tp, 0), Hkv // tp, Hq // tp
    hd = hkv * D
    page1 = 2 * RETRO_CAP

    def calls(x, m):
        """Each form on the tensors x (the shard on mesh m, or the whole
        tensors off-mesh: the plain kernel), cycling the layers."""
        cv = [cview(x["cents"][l]) for l in range(L)]
        out = {f"flash_decode_stacked_sharded_T{T}": (
            lambda l, T=T: impls._flash_stacked(x[f"q{T}"], x["k"], x["v"],
                                                l, valid[T], m))
            for T in (1, 7)}
        out.update({
            "flash_prefill_sharded": lambda l: impls._flash_prefill_dispatch(
                x["q128"], x["k"], x["v"], l, valid[128], m, s_cap=P),
            "flash_decode_intervals_sharded": lambda l: impls._flash_intervals(
                x["q1"], x["kf"][l], x["vf"][l], a, lo, hi_s, m,
                k_sink=x["sinks"][(l + 1) % L]),
            "flash_decode_stacked_masked_sharded": lambda l: _tail_attend(
                x["q1"], x["bk"], x["bv"], cm, l, ns, hi_q, m),
            "page_gather_sharded": lambda l: pg.page_gather_sharded(
                x["k"], x["v"], l, pages, QUEST_PAGE, mesh=m),
            "page_gather_single_sharded":
                lambda l: pg.page_gather_single_sharded(
                    x["store"], l, clusters, page1, mesh=m),
            "centroid_scores_sharded": lambda l: gs.centroid_scores_sharded(
                x["q1"], cv[l], mesh=m),
            "flash_decode_stacked_lse_sharded": lambda l: impls.flash_stacked_lse(
                x["q7"], x["k"], x["v"], l, valid[7], mesh=m)})
        return out

    def bound(bytes_, flops, peak=BF16_FLOPS_PER_S):
        tb, tf = bytes_ / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    def sdpa_masked(q, kk, vv, mask):
        Sx = kk.shape[1]
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kk.view(B, Sx, hkv, D).transpose(1, 2),
            vv.view(B, Sx, hkv, D).transpose(1, 2), attn_mask=mask,
            enable_gqa=True)

    slot_s = torch.arange(S, device=dev)
    slot_f = torch.arange(DRAFT_SLOTS, device=dev)
    col_q = torch.arange(QUEST_R, device=dev)
    k_read = [torch.cat([s["sinks"][(l + 1) % L], s["kf"][l, :, SINK:]],
                        dim=1) for l in range(L)]
    masks_q = [((col_q < QUEST_NS) & (cm[l, :, 0] != 0)
                | (col_q >= QUEST_NS) & (col_q < hi_q))[:, None, None, :]
               for l in range(L)]
    rows_idx = (torch.arange(B, device=dev)[:, None] * (S // QUEST_PAGE)
                + pages.long().clamp(0, S // QUEST_PAGE - 1)).reshape(-1)
    rows_1 = (torch.arange(B, device=dev)[:, None] * RETRO_C
              + clusters.long().clamp(0, RETRO_C - 1)).reshape(-1)
    cviews = [cview(s["cents"][l]) for l in range(L)]

    def attn_bytes(read_slots, q, rows_ints):
        return ((read_slots * hd * 2 + 2 * q.numel()) * item
                + rows_ints * 4)

    # (plain version, library call, bound) on the shard; the bounds count
    # the K/V slots each sequence reads (its longest row's valid_upto), not
    # the longest sequence's for all
    timed = {}
    for T in (1, 7):
        q, val = s[f"q{T}"], valid[T]
        mask = (slot_s[None, None, :] < val[:, :, None])[:, None]
        timed[f"flash_decode_stacked_sharded_T{T}"] = (
            lambda l, q=q, val=val: fd.attention_plain(q, s["k"], s["v"], l,
                                                       val),
            lambda l, q=q, mask=mask: sdpa_masked(q, s["k"][l], s["v"][l],
                                                  mask),
            bound(attn_bytes(int(val.amax(1).sum()), q, val.numel()),
                  4 * int(val.sum()) * hq * D))
    timed["flash_decode_stacked_lse_sharded"] = (
        lambda l: fd.attention_plain_lse(s["q7"], s["k"], s["v"], l,
                                         valid[7]),
        timed["flash_decode_stacked_sharded_T7"][1],
        timed["flash_decode_stacked_sharded_T7"][2])
    val_p = valid[128]
    mask_p = (slot_s[None, None, :P] < val_p[:, :, None])[:, None]
    timed["flash_prefill_sharded"] = (
        lambda l: fd.attention_plain(s["q128"], s["k"], s["v"], l, val_p,
                                     s_cap=P),
        lambda l: sdpa_masked(s["q128"], s["k"][l, :, :P], s["v"][l, :, :P],
                              mask_p),
        bound(attn_bytes(int(val_p.amax(1).sum()), s["q128"], val_p.numel()),
              4 * int(val_p.sum()) * hq * D))
    mask_i = ((slot_f < a[..., None]) | ((slot_f >= lo[..., None])
                                          & (slot_f < hi_s[..., None])))[:, None]
    read = int((a.amax(1) + hi_s.amax(1) - lo.amin(1)).sum())
    timed["flash_decode_intervals_sharded"] = (
        lambda l: fd.intervals_plain(s["q1"], s["kf"][l], s["vf"][l], a, lo,
                                     hi_s, s["sinks"][(l + 1) % L]),
        lambda l: sdpa_masked(s["q1"], k_read[l], s["vf"][l], mask_i),
        bound(attn_bytes(read, s["q1"], 3 * a.numel()),
              4 * int((a + hi_s - lo).sum()) * hq * D))
    attended = sum(int(mq.sum()) for mq in masks_q) / L   # a layer's mean
    timed["flash_decode_stacked_masked_sharded"] = (
        lambda l: fd.stacked_masked_plain(s["q1"], s["bk"], s["bv"], l, cm,
                                          ns, ns, hi_q),
        lambda l: sdpa_masked(s["q1"], s["bk"][l], s["bv"][l], masks_q[l]),
        bound(attn_bytes(attended, s["q1"], 3 * hi_q.numel())
              + B * QUEST_R * 4, 4 * attended * hq * D))
    n = QUEST_NS // QUEST_PAGE
    timed["page_gather_sharded"] = (
        lambda l: pg.page_gather_plain(s["k"], s["v"], l, pages, QUEST_PAGE),
        lambda l: [c[l].view(B * (S // QUEST_PAGE), -1).index_select(
            0, rows_idx) for c in (s["k"], s["v"])],
        bound(2 * 2 * B * n * QUEST_PAGE * hd * item + pages.numel() * 4, 0))
    timed["page_gather_single_sharded"] = (
        lambda l: pg.page_gather_single_plain(s["store"], l, clusters, page1),
        lambda l: s["store"][l].view(B * RETRO_C, -1).index_select(0, rows_1),
        bound(2 * B * RETRO_N * page1 * hd * item + clusters.numel() * 4, 0))
    timed["centroid_scores_sharded"] = (
        lambda l: gs.centroid_scores_plain(s["q1"], cviews[l]),
        None,
        bound(s["q1"].numel() * item + B * RETRO_C * hd * 4
              + B * hkv * RETRO_C * 4,
              2 * B * hq * RETRO_C * D + 4 * B * hq * RETRO_C,
              F32_FLOPS_PER_S))
    on_shard, on_whole = calls(s, m0), calls(w, None)
    times = {}
    for name, (plain, lib, (b_ms, b_by)) in timed.items():
        t = dict(ms=_time_ms(torch, on_shard[name], L, graph=True),
                 whole_ms=_time_ms(torch, on_whole[name], L, graph=True),
                 plain_ms=_time_ms(torch, plain, L, graph=True),
                 library_ms=None if lib is None else _time_ms(torch, lib, L,
                                                              graph=True),
                 bound_ms=b_ms, bound_by=b_by)
        times[name] = dict(t, shard_over_whole=t["ms"] / t["whole_ms"])
    _set_counts(saved)      # the checks' and timings' launches
    line(phase="sharded_kernels", model=MODEL_OF_D[128], Hq=Hq, Hkv=Hkv, D=D,
         tps=[2, 4], shards="contiguous copies of each rank's head block",
         bit_equal_to_whole=True, max_abs_err=errs, max_err_over_limit=ratios,
         times_tp2_rank0=times, seconds=time.perf_counter() - t_start)

    src = {"page_gather": "page_gather.cu",
           "page_gather_single": "page_gather.cu",
           "centroid_scores": "centroid_scores.cu",
           "flash_prefill": "flash_prefill.cu"}
    at = {"flash_decode_stacked_sharded":
          "magicdec_tpu/engine/attention_impls.py:62",
          "flash_prefill_sharded": "magicdec_tpu/engine/attention_impls.py:99",
          "flash_decode_intervals_sharded":
          "magicdec_tpu/engine/attention_impls.py:117",
          "flash_decode_stacked_masked_sharded":
          "magicdec_tpu/engine/retro.py:305",
          "page_gather_sharded": "magicdec_tpu/ops/pallas/page_gather.py:193",
          "page_gather_single_sharded":
          "magicdec_tpu/ops/pallas/page_gather.py:178",
          "centroid_scores_sharded":
          "magicdec_tpu/ops/pallas/gemm_softmax.py:69",
          "flash_decode_stacked_lse_sharded":
          "magicdec_tpu/engine/attention_impls.py:81"}
    rows = []
    for name, (_, _, base) in SHARDED.items():
        key = name + "_T1" if name == "flash_decode_stacked_sharded" else name
        t = times[key]
        rows.append({"name": name, "route": "cuda",
                     "source": "magicdec_tpu_torch/csrc/"
                               + src.get(base, "flash_decode.cu"),
                     "replaces": at[name], "launches": launches[name],
                     "max_abs_err": errs[key], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    return rows


# ---------------------------------------------------------------------------
# phases 13-14: times at the main path's shapes, the step and round profile
# ---------------------------------------------------------------------------

def _time_ms(torch, fn, n_layers, reps=3, iters=32, graph=False):
    """Mean ms per call over `iters` calls cycling through the layers (the
    caller's layers do not fit the 50 MB L2 together); best of `reps`.
    graph=False: CUDA events around calls launched from Python, so a call
    whose launches take the host longer than its work takes the device is
    timed at the host's pace. graph=True: the calls are captured in one CUDA
    graph and replayed, which times the device alone."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up: builds, kernel attributes
        for i in range(n_layers):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for i in range(iters):
                fn(i % n_layers)
        run = g.replay
    else:
        def run():
            for i in range(iters):
                fn(i % n_layers)
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _device_and_eager_ms(torch, fn, n_layers):
    """(device ms per call from a replayed CUDA graph, eager ms per call)."""
    return (_time_ms(torch, fn, n_layers, graph=True),
            _time_ms(torch, fn, n_layers))


def _sdpa(torch, q, k_cache, v_cache, layer, valid, ext):
    """scaled_dot_product_attention on the same work (the yardstick)."""
    import torch.nn.functional as F
    Bq, T, Hq, D = q.shape
    Hkv = k_cache.shape[-1] // D
    k = k_cache[layer, :, :ext].view(Bq, ext, Hkv, D).transpose(1, 2)
    v = v_cache[layer, :, :ext].view(Bq, ext, Hkv, D).transpose(1, 2)
    slot = torch.arange(ext, device=q.device)
    mask = (slot[None, None, :] < valid[:, :, None])[:, None]
    return F.scaled_dot_product_attention(q.transpose(1, 2), k, v,
                                          attn_mask=mask, enable_gqa=True)


def time_kernels(torch, dev, errs, launches, D=64):
    """The attention kernels and the gathers at head_dim D (both), and
    centroid_scores (at D = 64, the main path's): device ms, eager ms, plain
    ms, bound and library ms per kernel entry; `launches` are the main
    path's counts of this D's model."""
    from magicdec_tpu_torch.ops import flash_decode as fd
    from magicdec_tpu_torch.ops.attention import decode_valid_upto

    L, S, Hq, Hkv = 16, 4224, 32, 8
    x = _sfx(D)
    item = 2                                     # bf16
    g = torch.Generator(device=dev).manual_seed(5)
    k = torch.randn((L, B, S, Hkv * D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((L, B, S, Hkv * D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    saved = _counts()
    rows = []

    def bound(bytes_, flops):
        tb, tf = bytes_ / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    # decode: the AR step of the main path at mid-generation (T=1, every
    # sequence at P + 32 cached tokens); also the verify (T=7) and draft
    # (T=1 over the draft cache of BUDGET + S - P slots, as Engine sizes it)
    # shapes on the phase line
    shapes = {"ar": (1, P + 32, S), "verify": (7, P + 32, S),
              "draft": (1, BUDGET + 32, BUDGET + S - P)}
    extra = {}
    for name, (T, length, S_c) in shapes.items():
        q = torch.randn((B, T, Hq, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        kc = k[:, :, :S_c].contiguous() if S_c != S else k
        vc = v[:, :, :S_c].contiguous() if S_c != S else v
        valid = decode_valid_upto(
            torch.full((B,), length - T, dtype=torch.int32, device=dev), T)
        span = int(valid.max())
        bytes_ = (B * span * Hkv * D * 2 + 2 * q.numel()) * item + valid.numel() * 4
        flops = 4 * int(valid.sum()) * Hq * D
        t_k, t_e = _device_and_eager_ms(
            torch, lambda l: fd.flash_decode_stacked(q, kc, vc, l, valid), L)
        t_p = _time_ms(torch, lambda l: fd.attention_plain(q, kc, vc, l, valid),
                       L, graph=True)
        t_l = _time_ms(torch, lambda l: _sdpa(torch, q, kc, vc, l, valid, S_c),
                       L, graph=True)
        b_ms, b_by = bound(bytes_, flops)
        extra[name] = dict(T=T, cached=length, S=S_c, ms=t_k, eager_ms=t_e,
                           plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                           bound_by=b_by)
    ar = extra["ar"]
    rows.append({"name": "flash_decode_stacked" + x, "route": "cuda",
                 "source": "magicdec_tpu_torch/csrc/flash_decode.cu",
                 "replaces": "magicdec_tpu/ops/pallas/flash_decode.py:488",
                 "launches": launches["flash_decode_stacked"],
                 "max_abs_err": errs["flash_decode_stacked" + x], "ms": ar["ms"],
                 "plain_ms": ar["plain_ms"], "bound_ms": ar["bound_ms"],
                 "bound_by": ar["bound_by"], "library_ms": ar["library_ms"]})

    # intervals: the StreamingLLM draft steps (T=1, and T=2 re-feeding the
    # last accepted token) on the 1088-slot draft cache with the window full
    # (lengths 1060, between compactions: 16 sink + 1008 window slots)
    kf = k[:, :, :DRAFT_SLOTS].contiguous()
    vf = v[:, :, :DRAFT_SLOTS].contiguous()
    sinks = [kf[(l + 1) % L, :, :SINK].contiguous() for l in range(L)]
    k_read = [torch.cat([sinks[l], kf[l, :, SINK:]], dim=1) for l in range(L)]
    slot = torch.arange(DRAFT_SLOTS, device=dev)
    draft_shapes = {}
    for T in (1, 2):
        q = torch.randn((B, T, Hq, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        a, lo, hi = _stream_rows(torch, dev, [1060] * B, T, SINK)
        mask = ((slot < a[..., None]) | ((slot >= lo[..., None])
                                          & (slot < hi[..., None])))[:, None]
        # slots read once per sequence: [0, max a) u [min lo, max hi)
        read = int((a.amax(1) + hi.amax(1) - lo.amin(1)).sum())
        bytes_ = ((read * Hkv * D * 2 + 2 * q.numel()) * item
                  + 3 * a.numel() * 4)
        flops = 4 * int((a + hi - lo).sum()) * Hq * D

        def sdpa(l):
            import torch.nn.functional as F
            kk = k_read[l].view(B, DRAFT_SLOTS, Hkv, D).transpose(1, 2)
            vv = vf[l].view(B, DRAFT_SLOTS, Hkv, D).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kk, vv, attn_mask=mask, enable_gqa=True)

        t_k, t_e = _device_and_eager_ms(torch, lambda l: fd.flash_decode_intervals(
            q, kf[l], vf[l], a, lo, hi, k_sink=sinks[l]), L)
        t_p = _time_ms(torch, lambda l: fd.intervals_plain(
            q, kf[l], vf[l], a, lo, hi, sinks[l]), L, graph=True)
        t_l = _time_ms(torch, sdpa, L, graph=True)
        b_ms, b_by = bound(bytes_, flops)
        draft_shapes[f"T{T}"] = dict(attended=int((a + hi - lo)[0, -1]),
                                     S=DRAFT_SLOTS, ms=t_k, eager_ms=t_e,
                                     plain_ms=t_p, library_ms=t_l,
                                     bound_ms=b_ms, bound_by=b_by)
    # the sink twist of streaming_draft_attn, per layer and draft step:
    # rotating the sink rows apart (what the port does) against copying the
    # layer with the rotated rows written in (the JAX package's k_read)
    from magicdec_tpu_torch.models.config import ModelArgs
    from magicdec_tpu_torch.ops.rope import apply_rope, rope_cos_sin
    cos, sin = rope_cos_sin(ModelArgs.from_name(MODEL_OF_D[D]),
                            torch.full((B, 1), 33, device=dev))

    def twist(l):
        return apply_rope(kf[l, :, :SINK].reshape(B, SINK, Hkv, D), cos, sin)

    def twisted_copy(l):
        k_l = kf[l].clone()
        k_l[:, :SINK] = twist(l).reshape(B, SINK, Hkv * D)
        return k_l

    for what, f in (("sink_twist", twist), ("layer_copy_twist", twisted_copy)):
        draft_shapes[f"{what}_ms"], draft_shapes[f"{what}_eager_ms"] = (
            _device_and_eager_ms(torch, f, L))
    del kf, vf, sinks, k_read
    t1 = draft_shapes["T1"]

    # the return_lse forms at the GliDe shapes, every sequence at P + 32
    # verified slots: the tree verify's prefix part (flash_decode_stacked
    # with return_lse: T=7, tree (2,2)'s nodes; T=29, tree (4,2,2)'s, two
    # launches through attention_impls.flash_stacked_lse) and the tree
    # draft's own-prefix part (flash_decode_intervals with return_lse over a
    # 4224-slot flat layer: T = 1, 2, 4, tree (2,2)'s levels). SDPA on the
    # same work is the yardstick; it returns no (m, l)
    from magicdec_tpu_torch.engine.attention_impls import flash_stacked_lse
    length = P + 32
    lse_shapes = {}
    for form, Ts in (("stacked", (7, 29)), ("intervals", (1, 2, 4))):
        for T in Ts:
            q = torch.randn((B, T, Hq, D), generator=g, device=dev,
                            dtype=torch.bfloat16)
            hi = torch.full((B, T), length, dtype=torch.int32, device=dev)
            zero = torch.zeros_like(hi)
            rows_in = (1 if form == "stacked" else 3) * hi.numel() * 4
            bytes_ = ((B * length * Hkv * D * 2 + 2 * q.numel()) * item
                      + rows_in + 2 * B * T * Hq * 4)
            flops = 4 * int(hi.sum()) * Hq * D
            if form == "stacked":
                def kern(l):
                    return flash_stacked_lse(q, k, v, l, hi)

                def plain(l):
                    return fd.attention_plain_lse(q, k, v, l, hi)
            else:
                def kern(l):
                    return fd.flash_decode_intervals(q, k[l], v[l], zero, zero,
                                                     hi, return_lse=True)

                def plain(l):
                    return fd.intervals_plain_lse(q, k[l], v[l], zero, zero,
                                                  hi)
            t_k, t_e = _device_and_eager_ms(torch, kern, L)
            t_p = _time_ms(torch, plain, L, graph=True)
            t_l = _time_ms(torch, lambda l: _sdpa(torch, q, k, v, l, hi,
                                                  length), L, graph=True)
            b_ms, b_by = bound(bytes_, flops)
            lse_shapes[f"{form}_T{T}"] = dict(
                cached=length, launches_per_call=-(-T * 4 // 64), ms=t_k,
                eager_ms=t_e, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by)
    for name, key, at in (("flash_decode_stacked_lse", "stacked_T7", "488"),
                          ("flash_decode_intervals_lse", "intervals_T2",
                           "370")):
        r = lse_shapes[key]
        rows.append({"name": name + x, "route": "cuda",
                     "source": "magicdec_tpu_torch/csrc/flash_decode.cu",
                     "replaces": f"magicdec_tpu/ops/pallas/flash_decode.py:{at}",
                     "launches": launches[name], "max_abs_err": errs[name + x],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    rows.append({"name": "flash_decode_intervals" + x, "route": "cuda",
                 "source": "magicdec_tpu_torch/csrc/flash_decode.cu",
                 "replaces": "magicdec_tpu/ops/pallas/flash_decode.py:370",
                 "launches": launches["flash_decode_intervals"],
                 "max_abs_err": errs["flash_decode_intervals" + x],
                 "ms": t1["ms"],
                 "plain_ms": t1["plain_ms"], "bound_ms": t1["bound_ms"],
                 "bound_by": t1["bound_by"], "library_ms": t1["library_ms"]})

    # prefill: the last 128-token chunk of P=4096 (s_cap 4096), the chunk
    # with the most work; every earlier chunk is a shorter walk
    T = 128
    q = torch.randn((B, T, Hq, D), generator=g, device=dev, dtype=torch.bfloat16)
    valid = decode_valid_upto(
        torch.full((B,), P - T, dtype=torch.int32, device=dev), T)
    span = int(valid.max())
    bytes_ = (B * span * Hkv * D * 2 + 2 * q.numel()) * item + valid.numel() * 4
    flops = 4 * int(valid.sum()) * Hq * D
    t_k, t_e = _device_and_eager_ms(
        torch, lambda l: fd.flash_prefill(q, k, v, l, valid, s_cap=P), L)
    t_p = _time_ms(torch, lambda l: fd.attention_plain(q, k, v, l, valid,
                                                       s_cap=P), L, graph=True)
    t_l = _time_ms(torch, lambda l: _sdpa(torch, q, k, v, l, valid, P), L,
                   graph=True)
    b_ms, b_by = bound(bytes_, flops)
    rows.append({"name": "flash_prefill" + x, "route": "cuda",
                 "source": "magicdec_tpu_torch/csrc/flash_prefill.cu",
                 "replaces": "magicdec_tpu/ops/pallas/flash_decode.py:646",
                 "launches": launches["flash_prefill"],
                 "max_abs_err": errs["flash_prefill" + x], "ms": t_k,
                 "plain_ms": t_p,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": t_l})
    prefill = dict(ms=t_k, eager_ms=t_e, plain_ms=t_p, library_ms=t_l,
                   bound_ms=b_ms, bound_by=b_by)

    # masked: the Quest draft step (T=1) on the round buffer of budget 1024
    # (896 top columns + a 192-slot tail, R=1088) at mid-round tail lengths
    # (128 + 30 rows). "main": every top bit set, as in the main path (the 7
    # pages lie below the tail); "bits70": 70% of the top bits set
    import torch.nn.functional as F
    from magicdec_tpu_torch.ops.page_gather import page_gather, page_gather_plain
    bk = k[:, :, :QUEST_R].contiguous()
    bv = v[:, :, :QUEST_R].contiguous()
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev, dtype=torch.bfloat16)
    masked_shapes = {}
    for what, share in (("main", 1.0), ("bits70", 0.7)):
        cm, ns, hi = _quest_rows(torch, dev, 1, seed=70, top_share=share, L=L)
        hi = torch.full_like(hi, QUEST_NS + 159)
        col = torch.arange(QUEST_R, device=dev)
        masks = [((col < QUEST_NS) & (cm[l, :, 0] != 0)
                  | (col >= QUEST_NS) & (col < hi))[:, None, None, :]
                 for l in range(L)]
        # the bits of the layer used as a sample: the data-dependent work
        attended = int(masks[0].sum())
        bytes_ = ((attended * Hkv * D * 2 + 2 * q.numel()) * item
                  + B * QUEST_R * 4 + 3 * hi.numel() * 4)
        flops = 4 * attended * Hq * D

        def sdpa(l):
            kk = bk[l].view(B, QUEST_R, Hkv, D).transpose(1, 2)
            vv = bv[l].view(B, QUEST_R, Hkv, D).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kk, vv, attn_mask=masks[l], enable_gqa=True)

        t_k, t_e = _device_and_eager_ms(
            torch, lambda l: fd.flash_decode_stacked_masked(
                q, bk, bv, l, cm, ns, ns, hi), L)
        t_p = _time_ms(torch, lambda l: fd.stacked_masked_plain(
            q, bk, bv, l, cm, ns, ns, hi), L, graph=True)
        t_l = _time_ms(torch, sdpa, L, graph=True)
        b_ms, b_by = bound(bytes_, flops)
        masked_shapes[what] = dict(attended_per_seq=attended / B, ms=t_k,
                                   eager_ms=t_e, plain_ms=t_p, library_ms=t_l,
                                   bound_ms=b_ms, bound_by=b_by)
    m = masked_shapes["main"]
    rows.append({"name": "flash_decode_stacked_masked" + x, "route": "cuda",
                 "source": "magicdec_tpu_torch/csrc/flash_decode.cu",
                 "replaces": "magicdec_tpu/ops/pallas/flash_decode.py:738",
                 "launches": launches["flash_decode_stacked_masked"],
                 "max_abs_err": errs["flash_decode_stacked_masked" + x],
                 "ms": m["ms"], "plain_ms": m["plain_ms"],
                 "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                 "library_ms": m["library_ms"]})
    # page_gather: the round-opening step's gather at budget 1024 (7 of the
    # 33 pages of a 4224-slot layer, bf16) into the round buffer's top region
    n = QUEST_NS // QUEST_PAGE
    cpu_g = torch.Generator().manual_seed(71)
    pages = torch.stack([torch.randperm(S // QUEST_PAGE, generator=cpu_g)[:n]
                         for _ in range(B)]).to(dev, torch.int32)
    tops = [[buf[l, :, :QUEST_NS].view(B, n, QUEST_PAGE, -1) for buf in (bk, bv)]
            for l in range(L)]
    rows_idx = (torch.arange(B, device=dev)[:, None] * (S // QUEST_PAGE)
                + pages.long()).reshape(-1)

    def index_select(l):
        return [c[l].view(B * (S // QUEST_PAGE), -1).index_select(0, rows_idx)
                for c in (k, v)]

    bytes_ = 2 * 2 * B * n * QUEST_PAGE * Hkv * D * item + pages.numel() * 4
    t_k, t_e = _device_and_eager_ms(
        torch, lambda l: page_gather(k, v, l, pages, QUEST_PAGE, out=tops[l]), L)
    t_p = _time_ms(torch, lambda l: page_gather_plain(k, v, l, pages,
                                                      QUEST_PAGE), L, graph=True)
    t_l = _time_ms(torch, index_select, L, graph=True)
    b_ms, b_by = bound(bytes_, 0)
    gather = dict(pages=[B, n], ms=t_k, eager_ms=t_e, plain_ms=t_p,
                  library_ms=t_l, library="2x index_select (K, V)",
                  bound_ms=b_ms, bound_by=b_by)
    rows.append({"name": "page_gather" + x, "route": "cuda",
                 "source": "magicdec_tpu_torch/csrc/page_gather.cu",
                 "replaces": "magicdec_tpu/ops/pallas/page_gather.py:268",
                 "launches": launches["page_gather"],
                 "max_abs_err": errs["page_gather" + x], "ms": t_k,
                 "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": t_l})
    del tops

    # page_gather_single: the RetroInfer round-opening step's gather at
    # budget 1024 (28 of the 130 clusters of 2cap = 64 rows of the KV-fused
    # store, bf16) split into the round buffer's K and V top regions
    from magicdec_tpu_torch.ops.page_gather import (page_gather_single,
                                                    page_gather_single_plain)
    del k, v
    torch.cuda.empty_cache()
    page = 2 * RETRO_CAP
    store = torch.randn((L, B, RETRO_C * page, Hkv * D), generator=g,
                        device=dev, dtype=torch.bfloat16)
    clusters = torch.stack([torch.randperm(RETRO_C, generator=cpu_g)[:RETRO_N]
                            for _ in range(B)]).to(dev, torch.int32)
    tops = [[buf[l, :, :RETRO_NS].view(B, RETRO_N, RETRO_CAP, -1)
             for buf in (bk, bv)] for l in range(L)]
    rows_idx = (torch.arange(B, device=dev)[:, None] * RETRO_C
                + clusters.long()).reshape(-1)

    def index_select_single(l):
        return store[l].view(B * RETRO_C, -1).index_select(0, rows_idx)

    bytes_ = 2 * B * RETRO_N * page * Hkv * D * item + clusters.numel() * 4
    t_k, t_e = _device_and_eager_ms(torch, lambda l: page_gather_single(
        store, l, clusters, page, out=tops[l]), L)
    t_p = _time_ms(torch, lambda l: page_gather_single_plain(
        store, l, clusters, page), L, graph=True)
    t_l = _time_ms(torch, index_select_single, L, graph=True)
    b_ms, b_by = bound(bytes_, 0)
    gather_single = dict(clusters=[B, RETRO_N], page=page, ms=t_k,
                         eager_ms=t_e, plain_ms=t_p, library_ms=t_l,
                         library="1x index_select of whole 2cap-row pages",
                         bound_ms=b_ms, bound_by=b_by)
    rows.append({"name": "page_gather_single" + x, "route": "cuda",
                 "source": "magicdec_tpu_torch/csrc/page_gather.cu",
                 "replaces": "magicdec_tpu/ops/pallas/page_gather.py:169",
                 "launches": launches["page_gather_single"],
                 "max_abs_err": errs["page_gather_single" + x], "ms": t_k,
                 "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": t_l})
    del bk, bv, tops, store
    if D != 64:     # centroid_scores: once, at the main D
        torch.cuda.empty_cache()
        _set_counts(saved)
        line(phase="times" + x, D=D, model=MODEL_OF_D[D], decode_shapes=extra,
             intervals_shapes=draft_shapes, lse_shapes=lse_shapes,
             prefill_last_chunk=prefill, masked_shapes=masked_shapes,
             page_gather=gather, page_gather_single=gather_single)
        return rows

    # centroid_scores: the RetroInfer round-opening step's scoring (T=1,
    # Hq=32 over Hkv=8, the 130 float32 centroids of each layer read as a
    # strided view of [B, C, Hkv*D]); no single PyTorch call computes it
    from magicdec_tpu_torch.ops import gemm_softmax as gs
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev,
                    dtype=torch.bfloat16)

    def scores_bound(C):
        bytes_ = q.numel() * item + B * C * Hkv * D * 4 + B * Hkv * C * 4
        # the dots, and per logit a scale, an exponent and two sums
        flops = 2 * B * Hq * C * D + 4 * B * Hq * C
        tb, tf = bytes_ / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    # device ms against the cluster count (C = max_len / 32 grows with the
    # context: 1024 at P=32768), same q: the kernel at scores_plan's aim and
    # at each aim of SCORES_AIMS, the plain version and the bound
    by_c = {}
    for c in SCORES_CLUSTERS:
        cents = torch.randn((L, B, c, Hkv * D), generator=g, device=dev)
        views = [cents[l].view(B, c, Hkv, D).transpose(1, 2)
                 for l in range(L)]
        b_ms, b_by = scores_bound(c)
        by_c[c] = dict(
            ms=_time_ms(torch, lambda l: gs.centroid_scores(q, views[l]), L,
                        graph=True),
            plain_ms=_time_ms(torch, lambda l: gs.centroid_scores_plain(
                q, views[l]), L, graph=True),
            bound_ms=b_ms, bound_by=b_by, plan=gs.scores_plan(c, D),
            ms_by_cta_floats=_plan_sweep(
                torch, gs, lambda l: gs.centroid_scores(q, views[l]), L,
                "SCORES_CTA_FLOATS", SCORES_AIMS))
        if c == RETRO_C:
            t_k, t_e = _device_and_eager_ms(
                torch, lambda l: gs.centroid_scores(q, views[l]), L)
        del cents, views
    main = by_c[RETRO_C]
    t_p, b_ms, b_by = main["plain_ms"], main["bound_ms"], main["bound_by"]
    scores = dict(C=RETRO_C, ms=t_k, eager_ms=t_e, plain_ms=t_p,
                  library_ms=None, bound_ms=b_ms, bound_by=b_by,
                  ms_by_C=by_c, cta_floats=gs.SCORES_CTA_FLOATS)
    rows.append({"name": "centroid_scores", "route": "cuda",
                 "source": "magicdec_tpu_torch/csrc/centroid_scores.cu",
                 "replaces": "magicdec_tpu/ops/pallas/gemm_softmax.py:50",
                 "launches": launches["centroid_scores"],
                 "max_abs_err": errs["centroid_scores"], "ms": t_k,
                 "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None})
    _set_counts(saved)      # the timing launches are not the main path's
    line(phase="times", D=D, decode_shapes=extra, intervals_shapes=draft_shapes,
         lse_shapes=lse_shapes, lse_library="SDPA on the same work; it "
         "returns no (m, l)",
         prefill_last_chunk=prefill, masked_shapes=masked_shapes,
         page_gather=gather, page_gather_single=gather_single,
         centroid_scores=scores)
    return rows


# centroid_scores' cluster counts C timed (the main path's 130 among them),
# and the values of gs.SCORES_CTA_FLOATS (scores_plan's aim) timed at each
SCORES_CLUSTERS = (32, RETRO_C, 520, 1024)
SCORES_AIMS = (1024, 2048, 4096, 8192, 16384)


# the gather kernel's geometries timed against each other (ops/page_gather.py
# `_launch` knobs); the wrappers launch bulk_16k_x12, the fixed geometry
GATHER_VARIANTS = {
    "bulk_8k_x16": dict(chunk_bytes=8 << 10, stages=16),
    "bulk_16k_x12": dict(chunk_bytes=16 << 10, stages=12),
    "bulk_32k_x6": dict(chunk_bytes=32 << 10, stages=6),
    "bulk_64k_x3": dict(chunk_bytes=64 << 10, stages=3),
    "bulk_16k_x6_2cta": dict(chunk_bytes=16 << 10, stages=6, ctas_per_sm=2),
    "bulk_32k_x3_2cta": dict(chunk_bytes=32 << 10, stages=3, ctas_per_sm=2),
}


def gather_variants(torch, dev, L=16):
    """Every geometry of GATHER_VARIANTS on the `times` shapes of
    both gathers at both head dims (bf16, 16 layers cycled): device ms from
    a replayed CUDA graph, index_select's ms in the same call, and a bit
    check of each variant against the plain version into sentinel-filled
    outputs (fails if one differs). Then the kept kernel and index_select
    into the same kinds of destination: new outputs (as `times` times
    index_select) and 16 per-layer outputs (as the round buffer's layers)."""
    from magicdec_tpu_torch.ops import page_gather as pg

    S, n, page = 4224, QUEST_NS // QUEST_PAGE, 2 * RETRO_CAP
    saved = _counts()
    cpu_g = torch.Generator().manual_seed(72)
    pages = torch.stack([torch.randperm(S // QUEST_PAGE, generator=cpu_g)[:n]
                         for _ in range(B)]).to(dev, torch.int32)
    clusters = torch.stack([torch.randperm(RETRO_C, generator=cpu_g)[:RETRO_N]
                            for _ in range(B)]).to(dev, torch.int32)
    p_idx = (torch.arange(B, device=dev)[:, None] * (S // QUEST_PAGE)
             + pages.long()).reshape(-1)
    c_idx = (torch.arange(B, device=dev)[:, None] * RETRO_C
             + clusters.long()).reshape(-1)
    res = {}
    for D in HEAD_DIMS:
        HD = 8 * D
        g = torch.Generator(device=dev).manual_seed(73)
        k, v = (torch.randn((L, B, S, HD), generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        store = torch.randn((L, B, RETRO_C * page, HD), generator=g,
                            device=dev, dtype=torch.bfloat16)
        bufs = torch.empty((2, L, B, QUEST_R, HD), dtype=torch.bfloat16,
                           device=dev)
        q_tops = [[b_[l, :, :QUEST_NS].view(B, n, QUEST_PAGE, HD)
                   for b_ in bufs] for l in range(L)]
        r_tops = [[b_[l, :, :RETRO_NS].view(B, RETRO_N, RETRO_CAP, HD)
                   for b_ in bufs] for l in range(L)]
        want_q = pg.page_gather_plain(k, v, 0, pages, QUEST_PAGE)
        want_r = pg.page_gather_single_plain(store, 0, clusters, page)
        want_r = (want_r[:, :, :RETRO_CAP], want_r[:, :, RETRO_CAP:])
        times = {"index_select": {
            "page_gather": _time_ms(torch, lambda l: [
                c[l].view(-1, QUEST_PAGE * HD).index_select(0, p_idx)
                for c in (k, v)], L, graph=True),
            "page_gather_single": _time_ms(torch, lambda l: store[l].view(
                -1, page * HD).index_select(0, c_idx), L, graph=True)}}
        for name, knobs in GATHER_VARIANTS.items():
            _sentinel(torch, bufs)
            pg._gather_launch(k, v, 0, pages, QUEST_PAGE, q_tops[0], **knobs)
            pg._single_launch(store, 0, clusters, page, r_tops[1], **knobs)
            if not (_same(torch, q_tops[0], want_q)
                    and _same(torch, r_tops[1], want_r)):
                fail(f"gather variant {name} D={D}: not bit-exact")
            times[name] = {
                "page_gather": _time_ms(torch, lambda l: pg._gather_launch(
                    k, v, l, pages, QUEST_PAGE, q_tops[l], **knobs), L,
                    graph=True),
                "page_gather_single": _time_ms(
                    torch, lambda l: pg._single_launch(
                        store, l, clusters, page, r_tops[l], **knobs), L,
                    graph=True)}
        # the same work into the same kind of destination as index_select:
        # new outputs (the graph's pool hands each replay the same memory),
        # and 16 contiguous per-layer outputs for both
        q_outs = [[torch.empty((B, n, QUEST_PAGE, HD), dtype=torch.bfloat16,
                               device=dev) for _ in range(2)] for _ in range(L)]
        r_outs = [torch.empty((B, RETRO_N, page, HD), dtype=torch.bfloat16,
                              device=dev) for _ in range(L)]

        def rows_of(t, width):
            return t.view(-1, width * HD)

        same = {
            "kernel_new_output": (
                lambda l: pg.page_gather(k, v, l, pages, QUEST_PAGE),
                lambda l: pg.page_gather_single(store, l, clusters, page)),
            "kernel_into_layers": (
                lambda l: pg.page_gather(k, v, l, pages, QUEST_PAGE,
                                         out=q_outs[l]),
                lambda l: pg._single_launch(store, l, clusters, page,
                                            (r_outs[l],))),
            "index_select_into_layers": (
                lambda l: [torch.index_select(
                    rows_of(c[l], QUEST_PAGE), 0, p_idx,
                    out=rows_of(o, QUEST_PAGE)) for c, o in zip((k, v),
                                                                q_outs[l])],
                lambda l: torch.index_select(rows_of(store[l], page), 0,
                                             c_idx, out=rows_of(r_outs[l],
                                                                page)))}
        for name, (fq, fr) in same.items():
            times[name] = {
                "page_gather": _time_ms(torch, fq, L, graph=True),
                "page_gather_single": _time_ms(torch, fr, L, graph=True)}
        res[f"D{D}"] = times
        del k, v, store, bufs, q_tops, r_tops, q_outs, r_outs
        torch.cuda.empty_cache()
    _set_counts(saved)
    line(phase="gather_variants", ms=res, variants=GATHER_VARIANTS,
         shapes={"page_gather": [B, n, QUEST_PAGE],
                 "page_gather_single": [B, RETRO_N, page]},
         kept=dict(chunk_bytes=pg.CHUNK_BYTES, stages=pg.STAGES,
                   ctas_per_sm=pg.CTAS_PER_SM),
         bitexact=True)
    return res


def _int4pack_mm(torch, q4, s4):
    """torch._weight_int4pack_mm on the same weight, as a yardstick, or None
    where the card's torch lacks it: its nibbles are the same biased codes,
    packed along K in [N, K/2] bytes, with (scale, zero = 0) pairs in bf16,
    so it dequantizes (q - 8) * s as int4_matmul does."""
    from magicdec_tpu_torch.ops.int4_matmul import unpack_int4_cols
    if not hasattr(torch, "_weight_int4pack_mm"):
        return None
    codes = unpack_int4_cols(q4).t().contiguous()              # [N, K]
    packed = torch._convert_weight_to_int4pack(
        (codes[:, ::2] << 4 | codes[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([s4, torch.zeros_like(s4)], -1).to(torch.bfloat16)
    return lambda x: torch._weight_int4pack_mm(x, packed, 128, sz)


def _bound(bytes_, flops):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    3.35 TB/s and the bf16 operations over 989 TFLOP/s."""
    tb, tf = bytes_ / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# the split counts the sweep of time_int4 tries
INT4_SPLITS = (1, 2, 3, 4, 6, 8)


def _split_sweep(torch, plan_module, unit, counts, fn, L,
                 name="launch_plan"):
    """Device ms of fn (a call on layer l of L) with each split count S of
    counts in place of the plan plan_module.<name>'s: every K cut into
    min(S, K / unit) balanced ranges of whole unit-row pieces, as the plans
    cut it: {S: ms}."""
    plan = getattr(plan_module, name)
    res = {}
    try:
        for S in counts:
            def cut(K, N, S=S):
                n = K // unit
                s_ = min(S, n)
                return tuple((unit * (i * n // s_), unit * ((i + 1) * n // s_))
                             for i in range(s_))
            setattr(plan_module, name, cut)
            res[S] = _time_ms(torch, fn, L, graph=True)
    finally:
        setattr(plan_module, name, plan)
    return res


def time_int4(torch, dev, errs, launches, L=16):
    """int4_matmul at both models' four products (GEMM_MODELS) at every row
    count of INT4_ROWS, bf16 x, with 16 layers of weights cycled (they do not
    fit the 50 MB L2 together): device ms (CUDA graph), eager ms, the plain
    version and the bound (the packed weight, its scales and x read once,
    the output written once, over 3.35 TB/s; 2 M K N over 989 TFLOP/s).
    Yardsticks, which the port never calls: torch._weight_int4pack_mm where
    the card's torch has it, and the bf16 product with the dequantized
    weight (torch.mm). The sum of a layer's four products is taken at 256
    rows, the bucket of a B=8 decode step. Then the split sweep: the
    kernel at 64 and 256 rows with every split count of INT4_SPLITS in
    place of im.launch_plan's, so each run shows whether the plan's count
    is still the fastest at 256 rows (the rows it is made for)."""
    from magicdec_tpu_torch.ops import int4_matmul as im

    saved = _counts()
    g = torch.Generator(device=dev).manual_seed(90)
    int4, sweep = {}, {}
    for model, shapes in GEMM_MODELS.items():
        for name, K, N in shapes:
            packs = [im.pack_int4_cols(torch.randn(
                (K, N), generator=g, device=dev) * 0.02) for _ in range(L)]
            deq = [((im.unpack_int4_cols(q).float() - 8.0)
                    * s.repeat_interleave(128, 0)).to(torch.bfloat16)
                   for q, s in packs]
            try:
                fns = [_int4pack_mm(torch, q, s) for q, s in packs]
                if fns[0] is None:
                    fns = "unavailable: no torch._weight_int4pack_mm"
            except (RuntimeError, NotImplementedError) as e:
                fns = f"unavailable: {str(e).splitlines()[0][:120]}"
            for M in INT4_ROWS:
                x = torch.randn((M, K), generator=g, device=dev,
                                dtype=torch.bfloat16)
                t_k, t_e = _device_and_eager_ms(
                    torch, lambda l: im.int4_matmul(x, *packs[l]), L)
                t_p = _time_ms(torch, lambda l: im.int4_matmul_plain(
                    x, *packs[l]), L, graph=True)
                t_mm = _time_ms(torch, lambda l: x @ deq[l], L, graph=True)
                t_pack = fns if isinstance(fns, str) else _time_ms(
                    torch, lambda l: fns[l](x), L, graph=True)
                bytes_ = (K * N // 2 + K // 128 * N * 4) + 2 * M * (K + N)
                b_ms, b_by = _bound(bytes_, 2 * M * K * N)
                int4[f"{model}_{name}_M{M}"] = dict(
                    ms=t_k, eager_ms=t_e, plain_ms=t_p, bound_ms=b_ms,
                    bound_by=b_by, splits=len(im.launch_plan(K, N // 2)),
                    weight_int4pack_mm_ms=t_pack,
                    bf16_mm_dequantized_ms=t_mm)
                if M in (64, 256):
                    sweep[f"{model}_{name}_M{M}"] = _split_sweep(
                        torch, im, im.KERNEL_GROUP,
                        [S for S in INT4_SPLITS if S <= K // im.KERNEL_GROUP],
                        lambda l: im.int4_matmul(x, *packs[l]), L)
            del packs, deq, fns
            torch.cuda.empty_cache()
    steps = {f"{model}_M{M}": {k: sum(int4[f"{model}_{n}_M{M}"][k]
                                      for n, _, _ in shapes)
                               for k in ("ms", "bound_ms")}
             for model, shapes in GEMM_MODELS.items() for M in (64, 256)}
    _set_counts(saved)
    line(phase="times_int4", int4=int4, products_per_layer=steps,
         library="weight_int4pack_mm where available, else bf16 mm of the "
                 "dequantized weight")
    line(phase="int4_split_sweep", ms_by_splits=sweep,
         plan_is_fastest_at_256={k: min(v, key=v.get) == int4[k]["splits"]
                                 for k, v in sweep.items() if k.endswith("M256")})
    gu = int4["1b_w_gate_up_M256"]
    lib = gu["weight_int4pack_mm_ms"]
    return [{"name": "int4_matmul", "route": "cuda",
             "source": "magicdec_tpu_torch/csrc/int4_matmul.cu",
             "replaces": "magicdec_tpu/ops/pallas/int4_matmul.py:131",
             "launches": launches["int4_matmul"],
             "max_abs_err": errs["int4_matmul"], "ms": gu["ms"],
             "plain_ms": gu["plain_ms"], "bound_ms": gu["bound_ms"],
             "bound_by": gu["bound_by"],
             "library_ms": lib if isinstance(lib, float)
             else gu["bf16_mm_dequantized_ms"]}]


def time_int4_tp(torch, dev, launches, L=16):
    """int4_matmul at llama-3.2-1b's tp=2 shard shapes (INT4_TP2_SHAPES:
    the four products a rank of tp_1b ran, K and N/2 of the shard, whose
    launch_plan the kernel takes), at 256 rows (a B=8 decode step's
    bucket) and 128 (a dp=2 rank's B=4), bf16 x, L layers of weights
    cycled: each output within int4_matmul_plain_f32_and_limit, device ms
    (CUDA graph), eager ms, the plain version and the bound (the shard's
    packed weight, scales and x read once, the output written once, over
    3.35 TB/s; 2 M K N over 989 TFLOP/s); yardsticks the port never calls:
    torch._weight_int4pack_mm and the bf16 mm of the dequantized shard.
    Returns the kernels-line row: w_gate_up's shard at 256 rows (as
    int4_matmul's row), its launches those of tp_1b's int4 runs (both
    ranks)."""
    from magicdec_tpu_torch.ops import int4_matmul as im

    saved = _counts()
    g = torch.Generator(device=dev).manual_seed(91)
    res, err = {}, 0.0
    for name, (K, N2) in INT4_TP2_SHAPES.items():
        N = 2 * N2
        packs = [im.pack_int4_cols(torch.randn(
            (K, N), generator=g, device=dev) * 0.02) for _ in range(L)]
        deq = [((im.unpack_int4_cols(q).float() - 8.0)
                * s.repeat_interleave(128, 0)).to(torch.bfloat16)
               for q, s in packs]
        try:
            fns = [_int4pack_mm(torch, q, s) for q, s in packs]
            if fns[0] is None:
                fns = "unavailable: no torch._weight_int4pack_mm"
        except (RuntimeError, NotImplementedError) as e:
            fns = f"unavailable: {str(e).splitlines()[0][:120]}"
        for M in (128, 256):
            x = torch.randn((M, K), generator=g, device=dev,
                            dtype=torch.bfloat16)
            ref, limit = im.int4_matmul_plain_f32_and_limit(x, *packs[0])
            diff = (im.int4_matmul(x, *packs[0]).float() - ref).abs()
            if bool((diff > limit).any()):
                fail(f"int4_matmul at the tp=2 shard {name} (K={K}, "
                     f"N={N}), M={M}: outside the limit")
            err = max(err, float(diff.max()))
            t_k, t_e = _device_and_eager_ms(
                torch, lambda l: im.int4_matmul(x, *packs[l]), L)
            t_p = _time_ms(torch, lambda l: im.int4_matmul_plain(
                x, *packs[l]), L, graph=True)
            t_mm = _time_ms(torch, lambda l: x @ deq[l], L, graph=True)
            t_pack = fns if isinstance(fns, str) else _time_ms(
                torch, lambda l: fns[l](x), L, graph=True)
            bytes_ = (K * N // 2 + K // 128 * N * 4) + 2 * M * (K + N)
            b_ms, b_by = _bound(bytes_, 2 * M * K * N)
            res[f"{name}_M{M}"] = dict(
                K=K, N=N, ms=t_k, eager_ms=t_e, plain_ms=t_p, bound_ms=b_ms,
                bound_by=b_by, splits=len(im.launch_plan(K, N2)),
                weight_int4pack_mm_ms=t_pack, bf16_mm_dequantized_ms=t_mm)
        del packs, deq, fns
        torch.cuda.empty_cache()
    _set_counts(saved)
    line(phase="times_int4_tp2", model=MODEL_OF_D[64], tp=TP, shards=res,
         max_abs_err=err, launches_tp_1b=launches["int4_matmul"],
         library="weight_int4pack_mm where available, else bf16 mm of the "
                 "dequantized shard")
    gu = res["w_gate_up_M256"]
    lib = gu["weight_int4pack_mm_ms"]
    return [{"name": "int4_matmul_tp2_shards", "route": "cuda",
             "source": "magicdec_tpu_torch/csrc/int4_matmul.cu",
             "replaces": "magicdec_tpu/ops/pallas/int4_matmul.py:131",
             "launches": launches["int4_matmul"], "max_abs_err": err,
             "ms": gu["ms"], "plain_ms": gu["plain_ms"],
             "bound_ms": gu["bound_ms"], "bound_by": gu["bound_by"],
             "library_ms": lib if isinstance(lib, float)
             else gu["bf16_mm_dequantized_ms"]}]


# layers of weights the fused pair's timings cycle through: more than the
# 50 MB L2 holds (a llama-3.2-1b layer's post-attention weights are 109 MB,
# a llama-3.1-8b layer's 386 MB)
FUSED_TIME_LAYERS = {"1b": 16, "8b": 4}
# the split counts of the wo and w_down passes' sweep: the CTAs grow with S
# while each walks fewer stages, which parts a pass's fixed cost from its
# cost a stage
POST_SPLITS = (1, 2, 4, 8)
# the values of fb.PLAN_CTAS the whole fused_post_attn call is timed at, and
# of fb.QKV_PLAN_CTAS the whole fused_qkv call (the plans' split counts
# follow from them)
PLAN_CTAS_SWEEP = (32, 64, 128, 256)
QKV_CTAS_SWEEP = (64, 128, 192, 256)


def time_weight_kernels(torch, dev, errs, launches):
    """The fused pair at llama-3.2-1b's and llama-3.1-8b's widths, M = 8
    (AR and draft steps) and 56 (the verify), with FUSED_TIME_LAYERS layers
    of weights cycled: device ms (CUDA graph), eager ms, the plain version
    and the bound; each kernel of a call alone (device ms and bound: its
    weight, operands and output): fused_qkv's sums of squares and product,
    fused_post_attn's three passes, with the split counts of `launch_plan`;
    each whole call at each plan aim of PLAN_CTAS_SWEEP (fused_qkv:
    QKV_CTAS_SWEEP); and at M=8 the
    qkv product and the wo and w_down passes alone at each split count of
    POST_SPLITS. Yardstick, which the port never calls: the unfused chain
    of the bf16 path (rms_norm, cuBLAS products and the elementwise ops:
    two calls for fused_qkv, several for fused_post_attn). Then whether
    CUDA graph capture keeps the programmatic dependent launches between
    the kernels of a call (the programmatic edges of one captured call)."""
    import torch.nn.functional as F

    from magicdec_tpu_torch.ops import fused_block as fb
    from magicdec_tpu_torch.ops.norms import rms_norm

    saved = _counts()
    g = torch.Generator(device=dev).manual_seed(91)
    fused, sweep, plans, qkv_plans = {}, {}, {}, {}
    for model, (D, HqD, I, O) in FUSED_WIDTHS.items():
        L = FUSED_TIME_LAYERS[model]
        w = dict(n=[torch.ones(D, device=dev, dtype=torch.bfloat16)] * L,
                 wqkv=[], wo=[], gu=[], wd=[])
        for _ in range(L):
            for k, shape in (("wqkv", (D, O)), ("wo", (HqD, D)),
                             ("gu", (D, 2, I)), ("wd", (I, D))):
                w[k].append((torch.randn(shape, generator=g, device=dev)
                             * 0.02).to(torch.bfloat16))
        for M in (8, 56):
            x = torch.randn((M, D), generator=g, device=dev,
                            dtype=torch.bfloat16)
            ctx = torch.randn((M, HqD), generator=g, device=dev,
                              dtype=torch.bfloat16)

            def operands(l):
                return (x, ctx, w["wo"][l], w["n"][l], w["gu"][l], w["wd"][l])

            def qkv(l):
                return fb.fused_qkv(x, w["n"][l], w["wqkv"][l])

            def post(l):
                return fb.fused_post_attn(*operands(l))

            def qkv_plain(l):
                return fb.fused_qkv_plain(x, w["n"][l], w["wqkv"][l])

            def post_plain(l):
                return fb.fused_post_attn_plain(*operands(l))

            def qkv_chain(l):
                return rms_norm(x, w["n"][l]) @ w["wqkv"][l]

            def post_chain(l):
                t = x + ctx @ w["wo"][l]
                gu = (rms_norm(t, w["n"][l]) @ w["gu"][l].reshape(D, -1)).view(
                    M, 2, I)
                return t + (F.silu(gu[:, 0]) * gu[:, 1]) @ w["wd"][l]

            for what, fn, plain, chain, (wbytes, K_N) in (
                    ("fused_qkv", qkv, qkv_plain, qkv_chain,
                     (D * O * 2, D * O)),
                    ("fused_post_attn", post, post_plain, post_chain,
                     ((HqD * D + D * 2 * I + I * D) * 2,
                      HqD * D + D * 2 * I + I * D))):
                t_k, t_e = _device_and_eager_ms(torch, fn, L)
                t_p = _time_ms(torch, plain, L, graph=True)
                t_c = _time_ms(torch, chain, L, graph=True)
                act = 2 * M * ((D + O) if what == "fused_qkv"
                               else (2 * D + HqD))
                b_ms, b_by = _bound(wbytes + act, 2 * M * K_N)
                fused[f"{model}_{what}_M{M}"] = dict(
                    ms=t_k, eager_ms=t_e, plain_ms=t_p, unfused_chain_ms=t_c,
                    bound_ms=b_ms, bound_by=b_by)
            # fused_qkv's two kernels alone, on scratch a whole call filled
            qscratch = fb._qkv_launch(x, w["n"][0], w["wqkv"][0])
            nb = fb.column_blocks(D)
            qkv_plan = fb.qkv_plan(D, O)
            kernels = {}
            for bit, (name, nbytes, flops) in enumerate((
                    ("ssq", 2 * M * D + 4 * M * nb, 2 * M * D),
                    ("product", 2 * (D * O + D + M * (D + O)) + 4 * M * nb,
                     2 * M * D * O))):
                t_kernel = _time_ms(torch, lambda l, bit=bit: fb._qkv_launch(
                    x, w["n"][l], w["wqkv"][l], passes=1 << bit,
                    scratch=qscratch), L, graph=True)
                b_ms, b_by = _bound(nbytes, flops)
                kernels[name] = dict(ms=t_kernel, bound_ms=b_ms, bound_by=b_by)
            kernels["product"].update(
                splits=len(qkv_plan), ctas=fb.column_blocks(O) * len(qkv_plan))
            fused[f"{model}_fused_qkv_M{M}"]["kernels"] = kernels
            qkv_plans[f"{model}_M{M}"] = _plan_sweep(
                torch, fb, qkv, L, "QKV_PLAN_CTAS", QKV_CTAS_SWEEP)
            # each pass alone, on scratch a whole call filled
            scratch = fb._post_attn_launch(*operands(0))
            passes = {}
            for p, (name, K, N, nbytes) in enumerate((
                    ("wo", HqD, D, HqD * D + M * (HqD + 2 * D)),
                    ("gate_up", D, 2 * I, 2 * D * I + D + M * (D + I)),
                    ("down", I, D, I * D + M * (I + 2 * D)))):
                t_pass = _time_ms(torch, lambda l, p=p: fb._post_attn_launch(
                    *operands(l), passes=1 << p, scratch=scratch), L,
                    graph=True)
                b_ms, b_by = _bound(2 * nbytes, 2 * M * K * N)
                passes[name] = dict(ms=t_pass, bound_ms=b_ms, bound_by=b_by,
                                    splits=len(fb.launch_plan(K, N)),
                                    ctas=fb.column_blocks(N)
                                    * len(fb.launch_plan(K, N)))
            fused[f"{model}_fused_post_attn_M{M}"]["passes"] = passes
            plans[f"{model}_M{M}"] = _plan_sweep(torch, fb, post, L)
            if M == 8:  # the split products alone at each split count
                sweep[model] = {name: _split_sweep(
                    torch, fb, fb.STAGE_K, POST_SPLITS,
                    lambda l, p=p: fb._post_attn_launch(
                        *operands(l), passes=1 << p, scratch=scratch), L)
                    for p, name in ((0, "wo"), (2, "down"))}
                sweep[model]["qkv"] = _split_sweep(
                    torch, fb, fb.STAGE_K, POST_SPLITS,
                    lambda l: fb._qkv_launch(x, w["n"][l], w["wqkv"][l],
                                             passes=2, scratch=qscratch), L,
                    "qkv_plan")
            del x, ctx, scratch, qscratch
        del w
        torch.cuda.empty_cache()
    _set_counts(saved)
    line(phase="times_weights", fused=fused,
         fused_library="none: the unfused chain is several calls",
         pdl_in_capture=_pdl_in_capture(torch, dev, fb))
    line(phase="fused_split_sweep", ms_by_splits=sweep,
         whole_call_ms_by_plan_ctas=plans,
         qkv_whole_call_ms_by_plan_ctas=qkv_plans, plan_ctas=fb.PLAN_CTAS,
         qkv_plan_ctas=fb.QKV_PLAN_CTAS,
         plan={m: {"qkv": fused[f"{m}_fused_qkv_M8"]["kernels"]["product"][
             "splits"], **{k: v["splits"] for k, v in
                           fused[f"{m}_fused_post_attn_M8"]["passes"].items()}}
               for m in FUSED_WIDTHS})
    rows = []
    for what in ("fused_qkv", "fused_post_attn"):
        r = fused[f"1b_{what}_M8"]
        rows.append({"name": what, "route": "cuda",
                     "source": "magicdec_tpu_torch/csrc/fused_block.cu",
                     "replaces": "magicdec_tpu/ops/pallas/fused_block.py:"
                                 + ("96" if what == "fused_qkv" else "191"),
                     "launches": launches[what], "max_abs_err": errs[what],
                     "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": None})
    return rows


def _plan_sweep(torch, fb, call, L, aim="PLAN_CTAS", values=PLAN_CTAS_SWEEP):
    """Device ms of the whole call call(l) with the plan aim fb.<aim>
    (PLAN_CTAS, which launch_plan reads, or QKV_PLAN_CTAS, qkv_plan's) set
    to each of values: {value: ms}. The kernels overlap in a call
    (programmatic launch, CTAs of two kernels on an SM), so a plan is
    chosen on whole calls."""
    saved = getattr(fb, aim)
    res = {}
    try:
        for ctas in values:
            setattr(fb, aim, ctas)
            res[ctas] = _time_ms(torch, call, L, graph=True)
    finally:
        setattr(fb, aim, saved)
    return res


def _pdl_in_capture(torch, dev, fb):
    """The edges of CUDA graphs each holding one captured bf16 call at
    llama-3.2-1b's widths, M=8: with programmatic dependent launch kept by
    the capture, the edges between a call's kernels are of the
    programmatic type (fused_qkv: 1 of its 2 kernels, fused_post_attn: 2 of
    its 3). "not measured" where the card's torch cannot hand out the
    captured graph (CUDAGraph(keep_graph=True))."""
    D, HqD, I, O = FUSED_WIDTHS["1b"]
    bf = dict(device=dev, dtype=torch.bfloat16)
    ops = (torch.randn((8, D), **bf), torch.randn((8, HqD), **bf),
           torch.randn((HqD, D), **bf) * 0.02, torch.ones(D, **bf),
           torch.randn((D, 2, I), **bf) * 0.02, torch.randn((I, D), **bf) * 0.02)
    qkv_ops = (ops[0], ops[3], torch.randn((D, O), **bf) * 0.02)
    res = {}
    for name, call, want in (("fused_qkv", lambda: fb._qkv_launch(*qkv_ops), 1),
                             ("fused_post_attn",
                              lambda: fb._post_attn_launch(*ops), 2)):
        call()
        torch.cuda.synchronize()
        try:
            graph = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError as e:
            return f"not measured: {e}"
        with torch.cuda.graph(graph):
            call()
        edges, programmatic = fb.graph_edges(graph)
        graph.replay()
        torch.cuda.synchronize()
        res[name] = dict(edges=edges, programmatic_edges=programmatic,
                         kept=programmatic == want)
    return res


# the decode-phase row counts of a B=32 batch (the benchmark's): AR and draft
# steps, a gamma 4 verify, a GliDe tree (4,2,2) verify of 29 nodes; and the
# rows the unfused path runs each of them at (llama.row_bucket(32, T))
DECODE_ROWS = {"step": 32, "verify": 160, "tree_verify": 928}
PADDED_ROWS = 1024


def time_decode_rows(torch, dev):
    """The fused pair at llama-3.1-8b's widths (Mistral-7B's: dim 4096, 32/8
    heads of 128, FFN 14336) at each row count of DECODE_ROWS, beside the
    unfused chain (rms_norm, cuBLAS products, the elementwise ops) at the
    PADDED_ROWS rows the unfused path pads all of them to: device ms a
    layer (CUDA graph, FUSED_TIME_LAYERS["8b"] layers cycled), with the
    bound and each kernel of a call alone, and a forward's products both
    ways (a layer's times 32 layers). Fails unless the M=32 rows get the
    same bits inside every larger row count."""
    import torch.nn.functional as F

    from magicdec_tpu_torch.ops import fused_block as fb
    from magicdec_tpu_torch.ops.norms import rms_norm

    D, HqD, I, O = FUSED_WIDTHS["8b"]
    L, n_layer = FUSED_TIME_LAYERS["8b"], 32
    saved = _counts()
    g = torch.Generator(device=dev).manual_seed(93)
    bf = dict(device=dev, dtype=torch.bfloat16)
    w = {k: [(torch.randn(shape, generator=g, device=dev) * 0.02).to(
        torch.bfloat16) for _ in range(L)]
         for k, shape in (("wqkv", (D, O)), ("wo", (HqD, D)),
                          ("gu", (D, 2, I)), ("wd", (I, D)))}
    n = torch.ones(D, **bf)
    x = torch.randn((PADDED_ROWS, D), generator=g, device=dev).to(**bf)
    ctx = torch.randn((PADDED_ROWS, HqD), generator=g, device=dev).to(**bf)
    wbytes = 2 * (D * O + HqD * D + 2 * D * I + I * D)
    res, bits = {}, {}
    for name, M in (*DECODE_ROWS.items(), ("padded", PADDED_ROWS)):
        xm, cm = x[:M], ctx[:M]

        def qkv(l):
            return fb.fused_qkv(xm, n, w["wqkv"][l])

        def post(l):
            return fb.fused_post_attn(xm, cm, w["wo"][l], n, w["gu"][l],
                                      w["wd"][l])

        def chain(l):
            h = rms_norm(xm, n) @ w["wqkv"][l]
            t = xm + cm @ w["wo"][l]
            gu = (rms_norm(t, n) @ w["gu"][l].reshape(D, -1)).view(M, 2, I)
            return h, t + (F.silu(gu[:, 0]) * gu[:, 1]) @ w["wd"][l]

        b_ms, b_by = _bound(wbytes + 2 * M * (2 * D + O + HqD),
                            M * wbytes)
        r = dict(rows=M, bound_ms=b_ms, bound_by=b_by)
        if name == "padded":
            r["unfused_chain_ms"] = _time_ms(torch, chain, L, graph=True)
            r["forward_products_ms"] = n_layer * r["unfused_chain_ms"]
            res[name] = r
            continue
        r["fused_qkv_ms"] = _time_ms(torch, qkv, L, graph=True)
        r["fused_post_attn_ms"] = _time_ms(torch, post, L, graph=True)
        r["forward_products_ms"] = n_layer * (r["fused_qkv_ms"]
                                              + r["fused_post_attn_ms"])
        scratch = fb._post_attn_launch(xm, cm, w["wo"][0], n, w["gu"][0],
                                       w["wd"][0])
        r["passes_ms"] = {p_name: _time_ms(
            torch, lambda l, p=p: fb._post_attn_launch(
                xm, cm, w["wo"][l], n, w["gu"][l], w["wd"][l], passes=1 << p,
                scratch=scratch), L, graph=True)
            for p, p_name in enumerate(("wo", "gate_up", "down"))}
        qscratch = fb._qkv_launch(xm, n, w["wqkv"][0])
        r["qkv_product_ms"] = _time_ms(
            torch, lambda l: fb._qkv_launch(xm, n, w["wqkv"][l], passes=2,
                                            scratch=qscratch), L, graph=True)
        r["row_tiles"] = -(-M // 64)
        res[name] = r
        if M != DECODE_ROWS["step"]:
            m = DECODE_ROWS["step"]
            bits[name] = (
                torch.equal(fb.fused_qkv(x[:m], n, w["wqkv"][0]),
                            qkv(0)[:m])
                and torch.equal(fb.fused_post_attn(
                    x[:m], ctx[:m], w["wo"][0], n, w["gu"][0], w["wd"][0]),
                    post(0)[:m]))
            if not bits[name]:
                fail(f"decode_rows: the M={m} rows differ from the same rows "
                     f"inside M={M}")
        del scratch, qscratch
    _set_counts(saved)
    step = res["step"]["fused_qkv_ms"] + res["step"]["fused_post_attn_ms"]
    line(phase="decode_rows", widths=dict(D=D, HqD=HqD, I=I, O=O),
         layers_cycled=L, forward_layers=n_layer, rows=res,
         verify_over_step=(res["verify"]["fused_qkv_ms"]
                           + res["verify"]["fused_post_attn_ms"]) / step,
         rows_bitexact_at_32=bits)
    del w, x, ctx
    torch.cuda.empty_cache()


def _profile(torch, fn, n):
    """Device-busy share of n calls of fn (after 2 warm-up calls): the union
    of the kernel intervals torch.profiler records over the host wall time,
    kernels per call, the top kernels by device time and the top host ops
    by self CPU time (profiled, so inflated alike); the wall time per call
    is also taken without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: dict[str, float] = {}
    for e in kernels:
        key = e.name[:50]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    host = sorted(((e.key, e.self_cpu_time_total) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda kv: -kv[1])[:8]
    return dict(calls=n, wall_ms=plain_wall_ms / n,
                profiled_wall_ms=wall_ms / n, kernels=len(kernels) / n,
                device_busy_ms=busy_us / 1e3 / n,
                device_busy_share=busy_us / 1e3 / wall_ms,
                top_kernel_ms={k: v / 1e3 / n for k, v in top},
                top_host_self_ms={k: v / 1e3 / n for k, v in host})


def step_profile(torch, dev, steps=8, rounds=2):
    """Where the time of a decode step and of a speculation round goes, at
    the main path's shape after prefill: an AR step, a GliDe tree (2,2)
    round (3 glide forwards, a 7-node verify), and a SnapKV, a Quest and a
    RetroInfer round at budget 1024 (each drafting gamma tokens and
    verifying gamma + 1; with random weights one token is accepted per
    round).
    Launch counts made here are not the main path's."""
    import numpy as np

    from magicdec_tpu_torch.engine.backend import Engine
    from magicdec_tpu_torch.engine.quest import QuestState
    from magicdec_tpu_torch.engine.retro import RetroState, roundtail_round
    from magicdec_tpu_torch.engine.spec import _eot_array, snapkv_round
    from magicdec_tpu_torch.models import llama
    from magicdec_tpu_torch.models.config import ModelArgs

    saved = _counts()
    cfg = ModelArgs.from_name("llama-3.2-1b")
    params = llama.init_params(cfg, torch.bfloat16, scale=0.3, seed=0,
                               device=dev)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P))
    res = {}
    eng = Engine(cfg, params, batch_size=B, max_len=MAX_LEN)
    state = {"tok": eng.encode(prompt)}

    def ar_step():
        state["tok"] = eng.inference(state["tok"])

    res["ar_step"] = _profile(torch, ar_step, steps)
    del eng, state
    torch.cuda.empty_cache()
    from magicdec_tpu_torch.engine.glide_engine import (GlideEngine, SpecTree,
                                                        glide_tree_round)
    from magicdec_tpu_torch.models.glide import init_glide_params
    gp = init_glide_params(cfg, torch.bfloat16, scale=GLIDE_SCALE,
                           seed=GLIDE_SEED, device=dev)
    geng = GlideEngine(Engine(cfg, params, batch_size=B, max_len=MAX_LEN), gp)
    state = {"root": geng.encode(prompt)}
    tree, eot = SpecTree((2, 2)), _eot_array((), dev)

    def tree_round():
        geng.own_len, _, _, state["root"], _ = glide_tree_round(
            params, gp, cfg, tree, geng.target.cache, geng.own_k, geng.own_v,
            geng.own_len, state["root"], eot, use_flash=geng.use_flash)

    res["glide_tree_2_2_round"] = _profile(torch, tree_round, rounds)
    del geng, state, gp
    torch.cuda.empty_cache()
    from magicdec_tpu_torch.quant.int8 import quantize_params
    for mode in ("int8", "int4", "unfused"):
        w = params if mode == "unfused" else quantize_params(params, mode)
        with _fused_mode(llama, "off"):
            eng = Engine(cfg, w, batch_size=B, max_len=MAX_LEN)
            state = {"tok": eng.encode(prompt)}
            res[f"{mode}_ar_step"] = _profile(torch, ar_step, steps)
        del eng, state, w
        torch.cuda.empty_cache()
    for spec in ("snapkv", "quest", "retro"):
        eng = Engine(cfg, params, batch_size=B, max_len=MAX_LEN, spec=spec,
                     draft_budget=BUDGET, window_size=WINDOW,
                     latest_k=QUEST_TAIL, quest_page=QUEST_PAGE,
                     retro_cap=RETRO_CAP)
        state = {"buf": eng.encode(prompt),
                 "gen": torch.zeros(B, dtype=torch.int32, device=dev)}
        output = torch.zeros((B, NEW + GAMMA + 3), dtype=torch.int32,
                             device=dev)
        st = None
        if spec == "quest":
            st = QuestState.create(eng.cache, eng.spec_index, BUDGET,
                                   QUEST_TAIL, QUEST_PAGE, GAMMA)
        elif spec == "retro":
            st = RetroState.create(eng.cache, eng.spec_index, nprobe=RETRO_N,
                                   cap=RETRO_CAP, recent=QUEST_TAIL,
                                   gamma=GAMMA, max_new_tokens=NEW)

        def one_round():
            if st is None:
                state["buf"], state["gen"], _ = snapkv_round(
                    params, cfg, eng.cache, eng.draft, state["buf"], output,
                    state["gen"], eot, GAMMA)
            else:
                state["buf"], state["gen"], _ = roundtail_round(
                    params, cfg, eng.cache, st, state["buf"], output,
                    state["gen"], eot, GAMMA)

        res[f"{spec}_round"] = _profile(torch, one_round, rounds)
        del eng, st, state
        torch.cuda.empty_cache()
    _set_counts(saved)
    line(phase="step_profile", budget=BUDGET, gamma=GAMMA, **res)


if __name__ == "__main__":
    sys.exit(main())
