#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (abc_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

The port is self-contained, so nothing here can ask the JAX package for an
oracle. The card's results are held against (i) each kernel's plain torch
version on the card, (ii) the port's own CPU run of the same seed, word for
word, (iii) the plaintext oracle after decryption and (iv) golden SHA-256
digests of the reference's words, stored in
abc_tpu_torch/testdata/golden.json (tests/test_torch_golden.py recomputes
them from abc_tpu's np64 engine).

Phases, each of which raises on failure (the script then exits nonzero):

1. Build the kernels from abc_tpu_torch/csrc with nvcc (sm_90a), one nvcc
   per source, started together.
2. Kernel vs plain: ntt_fwd / ntt_inv against their plain torch versions on
   the card (torch.equal) at every n in {1024 .. 32768} x rows in {1, 12,
   14, 16, 18, 24, 42, 112, 896}, inputs holding 0 and q-1, so that every
   cluster size (1, 2, 4, 8 CTAs per row) is launched; inv(fwd(x)) == x;
   every main-path launch shape runs on at least 96 CTAs; the launch shapes
   of a batched mult+relin at n=8192 (B x 12, 16, 42, 18, 24, 14 rows at B
   in {8, 16, 64}: up to 2688 rows). Then, at the main
   path's launch shapes and the ablation's, kernel and plain times in CUDA
   events (median of 10 calls, of 3 for the plain versions, warm L2) and
   the profiler's device time,
   beside the bound: the larger of bytes moved over 3.35 TB/s and integer
   multiply-adds over 132 SMs x 64 per clock x 1.98 GHz.
2b. The BEHZ kernels (K3, abc_tpu_torch/csrc/behz.cu): behz_to_bsk,
   behz_tensor (base q and base Bsk in one launch), behz_fast_floor and
   behz_from_bsk torch.equal to their plain torch versions on the card at
   n=8192, L=6 (one ciphertext and a batch of 64), n=2048, L=16 (config 4's
   chain), n=16384, L=13, n=32768, L=27 (the largest L of
   BfvParams.create) and n=4096, L=65 (past 64 source limbs), inputs
   holding 0 and q-1, and on inputs all 0 and all q-1. At each of those
   shapes the time per call (CUDA events, median of 10), the profiler's
   device time, the bound (bytes, or the integer multiply-adds of the
   kernel's own arithmetic, behz_imads) and the plain version's time,
   beside what the compiler made of the instantiation launched (registers,
   shared memory, spills from ptxas -v; a SASS census) and its launch
   with its theoretical occupancy (abc_behz_launch_info).
2c. The key-switch kernels (K4, abc_tpu_torch/csrc/keyswitch.cu):
   ks_decompose (the digit lift), ks_contract (the contraction with both
   key halves, with and without a Galois permutation read in its loads,
   and with one half: a decryption's dot product of a ciphertext's two
   components with [1, s]) and ks_mod_down (the mod switch down of both accumulators, and the CKKS
   rescale) torch.equal to their plain torch versions on the card at BFV
   n=8192, L=6, k=1 and 2 (one ciphertext and a batch of 64), n=16384,
   L=13, and CKKS n=32768, 8 + 2 primes at level 8 and level 3, inputs
   holding 0 and q-1, and on inputs all 0, all q-1 and with the divided
   rows at p>>1 and (p>>1)+1. At the timed shapes the time per call, the
   profiler's device time, both again with the L2 flushed before each
   call ("cold"), the bound (ks_imads), the plain version's time and, for
   the k=1 lift, that of one torch.remainder giving the same words, beside
   the compiler's census of the instantiation launched and its launch
   with its theoretical occupancy (abc_ks_mod_down_plan, with the kept
   rows a thread; for ks_decompose and ks_contract abc_ks_plan, with the
   columns a thread, or the lanes a quad). Every kernel
   timed against its bound (phases 2, 2b, 7, 9, 13) gets the cold
   readings too, and a device time under its bound is marked as an L2
   reading.
2d. The key generation, encryption and decryption kernels (K5,
   abc_tpu_torch/csrc/rlwe.cu): rns_uniform (the Threefry uniform draw),
   ksk_compose (switching keys, the public key without a target term),
   rlwe_lift (the signed lift, with the encryption's adds) and
   bfv_dec_round (the scale-and-round with its boundary flag) torch.equal
   to their plain torch versions on the card: the public key at (8192, 6)
   and (16384, 13), config 2's relinearization key (α = 6), k = 2 at
   (8192, 6 + 2), CKKS (32768, 8 + 2, k = 2) with a relin and a Galois key,
   LaplaceSharpening's 19 keys in one batch, encryption of 1 and 64
   ciphertexts at (8192, 6), of one at (16384, 13) and CKKS's at (32768,
   8), decryption at (8192, 6) and (16384, 13); on key words 0 and
   0xFFFFFFFF, residues all 0 and all q-1, lifts of ±19 and 0, and
   fractions exactly 2^31 + d (d = 0, ±4095: flag, ±4096: none) next to m
   = t-1 and 3. At the timed cases warm and cold time, the profiler's
   device time, the bound (bytes, or the operations of rlwe_ops: the
   Threefry rounds counted, all integer operations over the SM's issue
   rate and the multiply-adds over their pipe's), the plain version's
   time, the library call's (torch.remainder, the lifts without base or
   message), the compiler's census and the launch with its occupancy
   (abc_rlwe_plan); no SASS CALL and no spill in rlwe_lift's and
   bfv_dec_round's instantiations; a flagged then an unflagged
   bfv_dec_round, and a graph of one call: one kernel node, no memset.
2e. The K9 kernels: ks_mod_down_relin and ks_mod_down_rotate (ks_mod_down
   of csrc/keyswitch.cu with the relinearization's adds, or the rotation's
   signed coefficient gather of c0 and its add, in the same launch) and the
   RNS elementwise ops of csrc/elementwise.cu (rns_ew_add, rns_ew_sub,
   rns_ew_mul, rns_ew_neg: ciphertext adds, plaintext products, the CKKS
   integer multiply by a column, the component-0 forms of add_plain and
   sub_from_plain) torch.equal to their plain versions on the card at
   phase 2c's shapes (BFV n=8192, L=6, k=1 and 2 at one ciphertext and at
   B=64, n=16384, L=13, CKKS n=32768, 8 + 2 primes at level 8 and level
   3), the rotation at Galois elements 3 and 2n-1 (both signs; its
   sources computed from g^-1), inputs holding 0 and q-1, and on inputs all
   0 and all q-1 at every timed shape and k=2 B=64; at one ciphertext and
   B=64 (k=1), k=2, n=16384 L=13 and CKKS level 8 warm and cold time,
   device time, the bound, the plain version's time, the compiler's census
   (no subroutine call, so no 64-bit division routine, and no spill) and
   the launch with its plan (quads or kept rows a thread) and occupancy.
   Then dependent chains under stress (chain_stress): rns_ew_mul ->
   rns_ew_add -> ks_mod_down_rotate whose add feeds the mod down's x or the
   rotation's c0, 200 eager runs and 200 graph replays each on fresh
   inputs, every result equal to plain.
3. BFV mult+relin at n=8192 (6 data primes, k=1 and k=2): keys,
   ciphertexts and result on the card equal to the port's CPU context of
   the same seed and to the golden digests; one multiply of fresh operands
   launches exactly 5 forward and 3 inverse transforms (154 limb rows at
   k=1), 2 behz_to_bsk, 1 behz_tensor, 1 behz_fast_floor and 1
   behz_from_bsk, and 1 ks_decompose, 1 ks_contract and 1
   ks_mod_down_relin; ms per op; the op captured as a CUDA graph, whose
   node list holds exactly those 16 kernels and no other, its replay
   timed and profiled; device time per named elementwise chain (the torch.profiler
   ranges of ops/modarith.chain_range), with no kernel outside the ranges,
   at one ciphertext and (k=1) at a batch of 64.
4. The main path: the README hamming program, compiled by the port's passes
   and run encrypted through run_compiled with the port's factory at
   n=8192, and a second request on the same factory (PLAIN_ARITH: a
   plaintext minus a ciphertext, a plaintext product, a ciphertext add,
   plaintext subtract and add, a negation). Launch counts of every
   hand-written kernel are taken over these runs and their decryptions
   alone, and each must be launched (but rns_uniform: only a context
   restored without its uniform key halves draws them apart from
   ksk_compose; and ks_mod_down: every BFV key switch ends in a tail, the
   plain form is the CKKS rescale's, counted in phase 9). Hamming's output
   words equal the CPU run and the golden digest, and decrypt to 2; the
   second request's equal the CPU run and decrypt to the plain oracle.
5. LaplaceSharpening at the reference's parameters (n=16384, 13 data
   primes): decrypts equal to the plain oracle, rotations share one hoisted
   decomposition, the NTT and key-switch kernels of a rotation, the
   elementwise adds and plaintext products launched and no BEHZ kernel and
   no relinearization, ksk_compose, rlwe_lift and bfv_dec_round launched;
   phase times.
6. Keys on the card: a fresh factory (keygen) and every Galois key that
   LaplaceSharpening used, timed, equal to phase 5's keys, with the key
   build's device time (profiler) beside its host clock; an encryption and
   its decryption; a context restored without the uniform key halves
   regenerating them. The launches of this path, counted alone, are the
   kernels line's for the K5 kernels, and each must be launched.
7. NTT ablation and ALU calibration: every mode of ablate_ntt (the shipping
   ntt_fwd design with one class of work removed) torch.equal to its plain
   version at (n, L, B) = (16384, 14, 1), (8192, 6, 3), (16384, 14, 8),
   (8192, 16, 4) and (8192, 12, 3), which reach every cluster size, so that
   every ablate_ntt_kernel<Mode, LOGC> runs; the four NTT modes also equal
   to ntt_fwd; both alu_chain kinds at [14, 128, 128] x 512 iterations equal
   to their plain versions. Then the path itself: `python -m
   abc_tpu_torch.scripts.ntt_ablation --quick`'s measurement, with the
   ablation module's launch counts taken over it alone, the SASS checks
   that the ALU chains were not folded and that `full` has ntt_fwd's
   instructions per butterfly, full_over_shipping, and its JSON on one
   line.
8. Whole-program execution (jit_compile_program / JittedProgram: the
   program as one CUDA graph). The README hamming program at n=8192 with
   phase 4's seed: run() decrypts to 2, the raw output words equal phase
   4's eager words and the golden digest; kernel launch counts are taken
   over this path alone (they move at set-up, warm-up and capture only),
   and the program's graph holds, by its node list, as many hand-written
   kernels of each kind as one eager walk of the program launches.
   Serving: three fresh input pairs through encrypt_inputs -> run_raw ->
   decrypt_outputs, each equal to the plain oracle and, word for word, to an
   eager executor run on the same ciphertexts, with ntt_kernels.launches and
   context.counters unchanged across the replays. auto_params=True chooses
   the same parameter set on the card as on the CPU, with the same words.
   LaplaceSharpening at n=16384 (phase 5's seed) as a graph: words equal to
   phase 5's, phase_ms, bytes of the graph's pool, ms per replay beside
   phase 5's second eager run. mult+relin at n=8192, k=1 as a graph (words
   equal to phase 3's op on the same operands): ms per replay beside phase 3's eager
   ms/op and device-kernel total. `python -m abc_tpu_torch hamming -
   --backend bfv --slots 8192` as a subprocess.
8b. Two captured programs of two contexts alive at once, replayed in turns:
   (i) the README hamming program (BFV n=8192) and the config-5 CKKS op
   (n=32768) through jit_compile_program, 10 rounds of fresh inputs through
   encrypt_inputs, every replay equal to its program's eager run on the
   same ciphertexts and to the oracle, no counter moving, and hamming's
   words on one input pair equal before the CKKS program existed and after
   the rounds; (ii) hybrid_ks_ab's first form (scripts/graph_lifetime.py,
   "held"): k=1 and k=2 contexts at n=8192, an eager multiply + decrypt on
   each, chain graphs of 16 and 8 steps of each on an input only the graphs
   hold, replayed in turns, equal to eager chains; (iii) ntt_inv captured at
   n=32768 on 48 rows (147456 B of shared memory), launched eagerly at
   n=16384 on 48 rows (73728 B), then replayed: equal to an eager run;
   (iv) a capture through utils/timing.capture_graph with Python's
   collector due and a graph of an earlier capture that only a reference
   cycle holds (scripts/graph_lifetime.py, "guarded"): captured and
   replayed equal, the old graph destroyed after the capture, not inside
   it.

9. CKKS at the reference's own CKKS size (n=32768, 8 data + 2 special
   primes of 30 bits, k=2, scale 2^25; abc_tpu/benchsuite.py config 5).
   Views: ntt_fwd / ntt_inv through leveled NttContext.subset views against
   their plain versions (torch.equal) at the op's launch shapes (16, 40
   rows forward; 24, 20 inverse) and at level 3 (9 and 10 rows), with times
   and the bound at the op's shapes. The op: multiply(a, a, rescale=False),
   eager: public key, relinearization key, ciphertext and result equal to
   the port's CPU run and the golden digests; 3 forward launches of 16, 16,
   40 rows and 2 inverse of 24, 20; ms/op; device time by kernel name; as
   a graph exactly its 9 hand-written kernels a replay. A
   leveled run at scale 2^29 (multiply with rescale, a second multiply at
   level 7 with its partial last digit, rotate and hoisted rotations of it,
   its rescale): words equal to the CPU run, decoded values against numpy. As a graph: the op
   itself and `p = a *** b; p = rotate(p, 1);` through jit_compile_program
   (words equal to the eager run and the CPU run, a replay on fresh inputs
   against numpy, no counter moving across replays, phase_ms, device_bytes,
   ms per replay), and one float program under auto_params=True. The packed
   matvec: matvec_bsgs_ckks at n=2048 (1024 x 1024) against numpy, one
   hoisted decomposition for the baby steps. Kernel launch counts are taken
   over this phase's driven path alone (the view comparisons come first).

10. The measurement entry point. The batch contract on the card: at B=8,
   multiply and rotate_rows of [B, 2, L, n] equal B separate calls word for
   word, and row 0 of the product equals the golden digest. Then `python -m
   abc_tpu_torch.bench --quick` in process (abc_tpu_torch/bench.py: the NTT
   and mult+relin batch curves at B in {1, 8, 16, 64}, the mult+relin floor,
   the six staged configs of abc_tpu_torch/benchsuite.py, every chain step
   held to its 5 + 3 launches while it is captured): no config may carry
   an error, config 3 must be correct, config 4's variants must decrypt
   alike, config 6 must equal the plain oracle, no headline value may be
   nan, the compact line must stay under 1500 characters. Its two lines are
   printed; kernel launch counts are taken over the bench alone.

11. Checkpoint / resume as a serving path (abc_tpu_torch/utils/
   checkpoint.py). A client (this process) compiles and captures the README
   hamming program at n=8192 (phase 4's seed; the capture builds the keys
   the program needs) and the config-5 CKKS op at n=32768 (8 + 2 primes,
   k=2, scale 2^25), and writes the circuits, the public contexts (seeded,
   without the secret: no master seed either) and two requests each. The
   server is a child process, `python3 chip_smoke.py --serve DIR`, that
   reads only those files: load_circuit -> load_context(device="cuda") ->
   JittedProgram -> run_raw, outputs written back. Its context holds no
   secret and builds no key; its launches of both NTT kernels are counted
   in its own process. The client decrypts every output to the oracle, and
   its words equal the client's own graph on the same ciphertexts (and, for
   CKKS, CkksContext.multiply on the operand). Seeded against full file
   bytes (under 0.65), the server's load time and ms per replay. Then
   abc_tpu's own checkpoint file (testdata, n=1024): restored keys equal to
   the stored digests, the stored ciphertext decrypts to its plaintext, one
   multiply + relin of it equals the golden product.
12. The reference-scale workloads of tests/test_e2e_reference_scale.py at
   its own parameters and seeds, each as one graph through
   jit_compile_program: the SoK batched cardio risk score at n=16384 (also
   through run_compiled; galois >= 4 and no ct x ct multiply), hamming over
   16 bits, boxblur, matvec_bsgs, roberts_cross, the linear and polynomial
   kernels, Gx, Gy, l2_distance and dot_product at n=8192, and the smoke
   program at n=4096: decrypts equal to the plain oracle, replay words
   equal to an eager walk on the same ciphertexts, no counter moving across
   replays, ms and kernels per replay. Kernel launches are counted over
   this phase alone.
13. The meshes (abc_tpu_torch/parallel/) at the reference's production
   shapes (abc_tpu/parallel/dryrun.py), on LocalComm: 8 shards on the card.
   First the shard-table launches: ntt_fwd / ntt_inv with the 8 shards'
   local-stage tables of the distributed NTT stacked into one launch (64
   rows at n = S = 4096) torch.equal to their plain versions, timed beside
   the bound; the mesh kernels (K8, csrc/mesh.cu) at the paths' shapes
   (k8_calls: the combine of (b)'s transform, of (c)'s digits and of its
   accumulators' last inverse stage with n^-1 folded, the psum of (a), over
   8 shards, and its rank form beside torch.remainder), each torch.equal
   to its plain version on random and all-(q-1) inputs, warm and cold
   device time against the bound. Then, launches counted over this path
   alone: (a)
   sharded_key_switch and sharded_rotate_rows at BFV n=8192 with 8 + 1
   primes on dp=2 x limb=4, equal to the single-device _key_switch /
   rotate_rows; (b) DistNttContext at n=32768, L=8, D=8: fwd (one launch
   for all shards), inv and negacyclic_mul equal to NttContext; (c)
   DistCkksMultiplier at n=32768, levels=8, k=1, D=8 equal to
   CkksContext.multiply(rescale=False), its launches the single-device
   op's and 15 combines (MESH_CKKS_CENSUS), eager ms, and as a graph: at
   most 100 kernel nodes, the hand-written ones and copies only; (d) the
   hamming program through jit_compile_program(mesh=dp 2 x limb 4,
   batch_values=...) at n=8192, batch 4, as one graph: decrypts equal to
   single-device runs of each row and the oracle, ms and kernels per
   replay, no count moving at a replay, its graph's census (graph_census:
   the hand-written kernels one walk launches, and every other kernel a
   copy, printed by name and count);
   (e) entry.dryrun_multichip(8): the small-shape dryrun and
   run_production_dryrun with step ms and the collective census. Then
   DistComm over NCCL: world = the visible cards, one spawned rank each,
   running (a) and (b) with the words of the LocalComm runs (with one card
   the world is 1: NCCL init and all_reduce, no exchange), the rank forms
   of the mesh kernels against their plain versions, each rank's mesh
   kernel launches, and a probe of whether an NCCL all_reduce can be
   captured in a CUDA graph.

Needs one CUDA device; exits nonzero at once without one. Imports nothing of
JAX or of abc_tpu. Prints the card's name and power limit, a
{"kernels": [...]} JSON line, and last {"ok": true, "device": {...}}.
"""

import functools
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# LaplaceSharpening as the reference runs it (abc_tpu/benchsuite.py config 6)
LAPLACE = """
  int weightMatrix = {1, 1, 1, 1, -8, 1, 1, 1, 1};
  secret int img2 = img;
  for (int x = 1; x < imgSize-1; x = x + 1) {
    for (int y = 1; y < imgSize-1; y = y + 1) {
      secret int value = 0;
      for (int j = -1; j < 2; j = j + 1) {
        for (int i = -1; i < 2; i = i + 1) {
          value = value + weightMatrix[(i + 1)*3 + j + 1]
              *img[(x + i)*imgSize + y + j];
        }
      }
      img2[imgSize*x + y] = 2*img[imgSize*x + y] - value;
    }
  }
  return img2;
"""
MAIN_N = 8192        # the bench headline preset: 6 data primes, t of 20 bits
LAPLACE_N = 16384    # the reference's own end-to-end parameters: 13 primes
LAPLACE_SEED = 23
# (n, L, batch) timed in phase 2: the launches of one n=8192 mult+relin
# (forward 12, 16, 12, 16, 42 rows; inverse 18, 24, 14) and the ablation's
NTT_SHAPES = [(8192, 6, 2), (8192, 8, 2), (8192, 7, 6), (8192, 6, 3),
              (8192, 8, 3), (8192, 7, 2), (16384, 14, 1), (16384, 14, 8)]
# the largest forward (key-switch decomposition, 42 rows) and inverse (Bsk
# tensor product, 24 rows) transform of one n=8192 mult+relin
JSON_SHAPE = {"ntt_fwd": (8192, 7, 6), "ntt_inv": (8192, 8, 3)}
MAIN_ROWS = (12, 14, 16, 18, 24, 42)     # per launch on the main path
SWEEP_N = (1024, 2048, 4096, 8192, 16384, 32768)
SWEEP_ROWS = ((1, 1), (12, 6), (14, 7), (16, 8), (18, 6), (24, 8), (42, 7),
              (112, 14), (896, 14))      # (rows, L)
# the launches of one n=8192 mult+relin on a batch of B ciphertexts, (rows
# per ciphertext, L): the bench's mult+relin curve launches B times these
BATCH_ROWS = ((12, 6), (16, 8), (42, 7), (18, 6), (24, 8), (14, 7))
BATCH_SIZES = (8, 16, 64)
# The card's rates for the bound: device memory (NVIDIA's data sheet) and
# 32-bit integer multiply-adds, 132 SMs x 64 per clock x 1.98 GHz (the SM
# clock read under load), the ceiling that alu_chain calibrates against.
HBM_BYTES_S = 3.35e12
IMAD_S = 132 * 64 * 1.98e9
# Any mix of 32-bit integer instructions: an SM's four dispatchers issue one
# warp instruction a clock each, 128 lanes, shared by the ALU pipe (adds,
# shifts, rotates, logic, compares, selects) and the FMA pipe (IMAD, and the
# adds, shifts and moves the compiler issues there as IMAD forms). So a
# kernel's integer operations take at least their count over this rate, and
# its multiply-adds at least theirs over IMAD_S.
INT_ISSUE_S = 132 * 128 * 1.98e9
IMAD_PER_BUTTERFLY = 3                   # one Shoup product
# the BEHZ kernels' shapes in phase 2b, (n, L, ciphertexts, t bits): t
# None takes BfvParams.create(n)'s chain, else L data primes of 30 bits and
# t of that many bits as benchsuite config 4 sizes them. The first is the
# main path's, where the kernels line reads its numbers.
BEHZ_SHAPES = [(8192, 6, 1, None), (8192, 6, 64, None), (2048, 16, 1, 14),
               (16384, 13, 1, None), (32768, 27, 1, None), (4096, 65, 1, 20)]
BEHZ_EDGE_SHAPES = [(8192, 6, 1, None), (8192, 6, 64, None),
                    (32768, 27, 1, None), (4096, 65, 1, 20)]
BEHZ = ("behz_to_bsk", "behz_tensor", "behz_fast_floor", "behz_from_bsk")
# slots of the integer multiply-add pipe taken by each step of the BEHZ kernels
# (csrc/behz.cu), the least each takes: a 32x32 -> 64-bit multiply-add, one;
# a Shoup product by a table constant (mul_const), three; reduce64 (a 64x64
# high product of four 32-bit partial products, and one low product), five
BEHZ_IMAD = {"wide": 1, "shoup": 3, "reduce64": 5}
PHASE3_BATCH = 64       # the bench curve's largest batch
# hand-written kernel launches of one BFV mult+relin (k = 1 or 2) and of the
# CKKS config-5 op
# (no key generation, encryption or decryption kernel)
NO_RLWE = {"rns_uniform": 0, "ksk_compose": 0, "rlwe_lift": 0,
           "bfv_dec_round": 0}
# the K9 kernels: ks_mod_down with the relinearization's and the
# rotation's tails (csrc/keyswitch.cu) and the RNS elementwise ops
# (csrc/elementwise.cu)
K9A = ("ks_mod_down_relin", "ks_mod_down_rotate")
K9B = ("rns_ew_add", "rns_ew_sub", "rns_ew_mul", "rns_ew_neg")
NO_K9B = {name: 0 for name in K9B}
# the mesh kernels (K8, csrc/mesh.cu): only the mesh paths (phase 13) run
# them
MESH_K = ("dist_ntt_combine", "rns_psum_mod")
NO_MESH = {name: 0 for name in MESH_K}
# every launch of a replay is one of these: a relinearization finishes in
# ks_mod_down_relin, and the BFV multiply and the CKKS op run no
# elementwise op
MULT_RELIN_CENSUS = {"ntt_fwd": 5, "ntt_inv": 3, "behz_to_bsk": 2,
                     "behz_tensor": 1, "behz_fast_floor": 1,
                     "behz_from_bsk": 1, "ks_decompose": 1, "ks_contract": 1,
                     "ks_mod_down": 0, "ks_mod_down_relin": 1,
                     "ks_mod_down_rotate": 0, **NO_RLWE, **NO_K9B,
                     **NO_MESH}
CKKS_OP_CENSUS = {"ntt_fwd": 3, "ntt_inv": 2, "behz_to_bsk": 0,
                  "behz_tensor": 1, "behz_fast_floor": 0, "behz_from_bsk": 0,
                  "ks_decompose": 1, "ks_contract": 1, "ks_mod_down": 0,
                  "ks_mod_down_relin": 1, "ks_mod_down_rotate": 0,
                  **NO_RLWE, **NO_K9B, **NO_MESH}
# one BFV rotation: the decomposition's forward transform, the inverse of
# the accumulators and the key switch ending in its tail
ROTATE_CENSUS = {name: int(name in ("ntt_fwd", "ntt_inv", "ks_decompose",
                                    "ks_contract", "ks_mod_down_rotate"))
                 for name in MULT_RELIN_CENSUS}
# the key-switch kernels (K4, csrc/keyswitch.cu) and their shapes in phase
# 2c, (scheme, n, L data primes, k special primes, ciphertexts, level): BFV
# at the main path's n=8192 (k = 1 and 2, one ciphertext and the bench's
# B=64), LaplaceSharpening's n=16384, CKKS config 5's n=32768 at full level
# and at level 3 (a partial digit). The first is the main path's, where the
# kernels line reads its numbers.
KS = ("ks_decompose", "ks_contract", "ks_mod_down")
KS_SHAPES = [("bfv", 8192, 6, 1, 1, 6), ("bfv", 8192, 6, 1, 64, 6),
             ("bfv", 8192, 6, 2, 1, 6), ("bfv", 8192, 6, 2, 64, 6),
             ("bfv", 16384, 13, 1, 1, 13), ("ckks", 32768, 8, 2, 1, 8),
             ("ckks", 32768, 8, 2, 1, 3)]
KS_EDGE_SHAPES = [KS_SHAPES[0], KS_SHAPES[1], KS_SHAPES[3], KS_SHAPES[5]]
KS_TIMED = KS_SHAPES[:6]
# the key generation, encryption and decryption kernels (K5, csrc/rlwe.cu)
# and their cases in phase 2d, (what, scheme, n, L data primes, k special
# primes, keys, ciphertexts): the public key at the main path's n=8192 and
# LaplaceSharpening's n=16384; switching keys: config 2's relin key (α = 6),
# k = 2 (α = 3), CKKS config 5's relin and a Galois key at n=32768, and
# LaplaceSharpening's 19 keys in one batch; the encryption of 1 and of 64
# ciphertexts; decryption at n=8192 and n=16384; the encryption of one
# ciphertext at LaplaceSharpening's n=16384 (config 6) and CKKS config 5's
# at n=32768 (plaintext rows added to c0, no Δ).
RLWE = tuple(NO_RLWE)
RLWE_CASES = [
    ("pk", "bfv", 8192, 6, 1, 0, 0), ("pk", "bfv", 16384, 13, 1, 0, 0),
    ("keys", "bfv", 8192, 6, 1, 1, 0), ("keys", "bfv", 8192, 6, 2, 1, 0),
    ("keys", "ckks", 32768, 8, 2, 2, 0), ("keys", "bfv", 16384, 13, 1, 19, 0),
    ("enc", "bfv", 8192, 6, 1, 0, 1), ("enc", "bfv", 8192, 6, 1, 0, 64),
    ("dec", "bfv", 8192, 6, 1, 0, 0), ("dec", "bfv", 16384, 13, 1, 0, 0),
    ("enc", "bfv", 16384, 13, 1, 0, 1), ("enc", "ckks", 32768, 8, 2, 0, 1)]
RLWE_KEYS19 = RLWE_CASES[5]
RLWE_TIMED = [RLWE_CASES[i] for i in (0, 2, 5, 6, 7, 8, 9, 10, 11)]
RLWE_EDGE_CASES = [RLWE_CASES[i] for i in (0, 2, 4, 6, 8, 9, 10, 11)]
# where the kernels line reads each: LaplaceSharpening's key build (its 19
# keys' uniform halves, error lift and composition) and decryption
RLWE_JSON = {"rns_uniform": (RLWE_KEYS19, "rns_uniform"),
             "ksk_compose": (RLWE_KEYS19, "ksk_compose"),
             "rlwe_lift": (RLWE_KEYS19, "lift_errors"),
             "bfv_dec_round": (RLWE_CASES[9], "bfv_dec_round")}
# integer operations of one Threefry-2x32 block: 20 rounds of an add, a
# rotate and an xor, 5 key injections of two adds, the counter's two adds
THREEFRY_OPS = 3 * 20 + 2 * 5 + 2
REPLACES = {
    "ntt_fwd": "abc_tpu/ops/pallas_ntt.py:265 (_fwd_kernel via "
               "pallas_fwd_ntt :417, pallas_fwd_ntt_fp :440)",
    "ntt_inv": "abc_tpu/ops/pallas_ntt.py:309 (_inv_kernel via "
               "pallas_inv_ntt :469, pallas_inv_ntt_fp :496)",
    "ablate_ntt": "scripts/ntt_ablation.py:85 (_ablate_kernel via "
                  "ablate_ntt :178)",
    "alu_chain": "scripts/ntt_ablation.py:201 (_alu_mac_kernel), :210 "
                 "(_alu_shoup_kernel) via alu_chain :221",
    # XLA-fused chains of the jx32 engine under jax.jit on the TPU
    "behz_to_bsk": "abc_tpu/crypto/behz.py:133 (_to_bsk, with _fastconv "
                   ":117)",
    "behz_tensor": "abc_tpu/crypto/behz.py:241 (tensor in multiply)",
    "behz_fast_floor": "abc_tpu/crypto/behz.py:161 (_fast_floor)",
    "behz_from_bsk": "abc_tpu/crypto/behz.py:172 (_from_bsk)",
    "ks_decompose": "abc_tpu/crypto/bfv.py:941 (_decompose_ntt's digit "
                    "lift), abc_tpu/crypto/ckks.py:848 (_decompose_ntt)",
    "ks_contract": "abc_tpu/crypto/bfv.py:979 (_ks_inner's contraction), "
                   "abc_tpu/crypto/ckks.py:880 (_ks_inner)",
    "ks_mod_down": "abc_tpu/crypto/bfv.py:1026 (_mod_switch_down), "
                   "abc_tpu/crypto/ckks.py:902 (_mod_switch_down), :775 "
                   "(rescale)",
    "rns_uniform": "abc_tpu/crypto/prng.py:148 (uniform_rns_jx_keys, with "
                   "threefry2x32 :91)",
    "ksk_compose": "abc_tpu/crypto/bfv.py:1251 (_ksk_batch_jit), :1220 "
                   "(_keygen_dev_jit's pk_b)",
    "rlwe_lift": "abc_tpu/crypto/bfv.py:1211 (_lift_signed_u32), :1288 "
                 "(_enc_jit's adds)",
    "bfv_dec_round": "abc_tpu/crypto/bfv.py:1311 (_dec_jit's "
                     "scale-and-round)",
    "ks_mod_down_relin": "abc_tpu/crypto/bfv.py:904-907 (relinearize's "
                         "adds and stack), abc_tpu/crypto/ckks.py:771-774",
    "ks_mod_down_rotate": "abc_tpu/crypto/bfv.py:1117-1121 (apply_galois's "
                          "signed gather, add and stack), :1165 "
                          "(hoisted_rotations), abc_tpu/crypto/ckks.py:993, "
                          ":1021",
    "rns_ew_add": "abc_tpu/ops/modarith.py:116 (jx32.add) at "
                  "abc_tpu/crypto/bfv.py:802, :817, "
                  "abc_tpu/crypto/ckks.py:624",
    "rns_ew_sub": "abc_tpu/ops/modarith.py:122 (jx32.sub) at "
                  "abc_tpu/crypto/bfv.py:806, :821, "
                  "abc_tpu/crypto/ckks.py:629",
    "rns_ew_mul": "abc_tpu/ops/modarith.py:132 (jx32.mul) at "
                  "abc_tpu/crypto/bfv.py:812, :831, "
                  "abc_tpu/crypto/ckks.py:718, :761",
    "rns_ew_neg": "abc_tpu/ops/modarith.py:127 (jx32.neg) at "
                  "abc_tpu/crypto/bfv.py:809, :825",
    # the mesh paths' chains, jx32 under shard_map and jax.jit
    "dist_ntt_combine": "abc_tpu/parallel/dist_ntt.py:171 (fwd_local's "
                        "combine :189-192), :208 (inv_local's combine "
                        ":223-226, with its n^-1 scale :237)",
    "rns_psum_mod": "abc_tpu/parallel/sharding.py:85 (_psum_mod)",
}
SOURCE = {"ntt_fwd": "abc_tpu_torch/csrc/ntt.cu",
          "ntt_inv": "abc_tpu_torch/csrc/ntt.cu",
          "ablate_ntt": "abc_tpu_torch/csrc/ntt_ablation.cu",
          "alu_chain": "abc_tpu_torch/csrc/ntt_ablation.cu",
          **{name: "abc_tpu_torch/csrc/behz.cu" for name in BEHZ},
          **{name: "abc_tpu_torch/csrc/keyswitch.cu" for name in KS + K9A},
          **{name: "abc_tpu_torch/csrc/rlwe.cu" for name in RLWE},
          **{name: "abc_tpu_torch/csrc/elementwise.cu" for name in K9B},
          **{name: "abc_tpu_torch/csrc/mesh.cu" for name in MESH_K}}
# CKKS at the reference's own size (abc_tpu/benchsuite.py config 5): the
# launches of one multiply(a, a, rescale=False) as (kernel, level, with the
# special primes, batch): forward 2 x 8 = 16 rows (each operand) and 4 x 10 =
# 40 (key-switch decomposition), inverse 3 x 8 = 24 (tensor product) and 2 x
# 10 = 20 (key-switch accumulators); then the shapes of a key switch at
# level 3 (3 and 5 rows per component)
CKKS_OP_SHAPES = [("ntt_fwd", 8, False, 2), ("ntt_fwd", 8, True, 4),
                  ("ntt_inv", 8, False, 3), ("ntt_inv", 8, True, 2)]
CKKS_LOW_SHAPES = [("ntt_fwd", 3, False, 3), ("ntt_fwd", 3, True, 2),
                   ("ntt_inv", 3, False, 3), ("ntt_inv", 3, True, 2)]
CKKS_CENSUS = [("ntt_fwd", 16), ("ntt_fwd", 16), ("ntt_inv", 24),
               ("ntt_fwd", 40), ("ntt_inv", 20)]       # in launch order
# the shapes the kernels line reports for CKKS: the largest forward and
# inverse launch of the op
CKKS_JSON_SHAPE = {"ntt_fwd": (8, True, 4), "ntt_inv": (8, False, 3)}
CKKS_MATVEC_N = 2048
CKKS_DEPTH2 = ("secret double acc = w0 * w1; acc = acc + rotate(w0, 1); "
               "acc = acc * w1; return acc;")
# (n, L, batch) of the ablation: the measurement's own shape first, then one
# shape per cluster size, so that every ablate_ntt_kernel<Mode, LOGC> runs:
# C = 8 (14 and 18 rows), 1 (112 rows), 2 (64), 4 (36)
ABLATION_SHAPES = [(16384, 14, 1), (8192, 6, 3), (16384, 14, 8),
                   (8192, 16, 4), (8192, 12, 3)]
ALU_SHAPE, ALU_ITERS = (14, 128, 128), 512
# where the kernels line times the ablation kernels: mode / kind
ABLATION_TIMED = {"ablate_ntt": "full", "alu_chain": "shoup"}


def l2_flush():
    """Leave none of the next call's operands in the card's L2
    (utils/timing.l2_flush: a float sum, whose kernels kernels_of(l2_flush)
    names): a "cold" reading, against the DRAM bound."""
    from abc_tpu_torch.utils.timing import l2_flush as flush
    flush()


def trace_marker():
    """A short kernel of its own, run alone at each end of a kernel_profile
    trace: the profiler can lose a trace's first or last kernel records
    (one or two a trace in chip_smoke's long process on an H100 80GB HBM3,
    none in a fresh one), and the markers take those places."""
    torch.cuda._sleep(1 << 12)
    torch.cuda.synchronize()


_names = {}


def kernels_of(fn):
    """The names of the device kernels fn() launches, read once from a
    profile of its own, so that kernel_profile leaves them out. The first
    profiles of a process can come back without a kernel record (three in
    a row once, on an H100 80GB HBM3 at 700 W, before any other profile of
    the process), so fn() runs three times a profile, up to ten
    profiles."""
    from torch.profiler import ProfilerActivity, profile
    if fn not in _names:
        fn()
        torch.cuda.synchronize()
        for _ in range(10):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
            names = {ev.name for ev in prof.events()
                     if ev.device_type == torch.autograd.DeviceType.CUDA}
            if names:
                _names[fn] = names
                break
        check(fn in _names, f"the profiler saw no kernel of {fn.__name__}")
    return _names[fn]


def cuda_ms(fn, reps=10, cold=False):
    """Median time of one fn() call in ms between CUDA events (after a
    warm-up): device time plus any host time the call adds between them.
    Cold: the L2 flushed before each call, outside the events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cold:
            l2_flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def per_call_ms(total, counts, reps):
    """{kernel name: device ms a call} from a profile of `reps` calls: each
    kernel's summed ms over its records seen, times its launches a call
    rounded (at least one), so that a kernel launched once a call whose
    trace lost records still reads its whole time. `counts`: records a
    call by kernel name."""
    return {name: ms / (counts[name] * reps) * max(1, round(counts[name]))
            for name, ms in total.items()}


def kernel_profile(fn, reps=5, cold=False):
    """Device kernels of fn() from torch.profiler, per call: (total kernel
    ms, kernel launches, {kernel name: ms}, {kernel name: launches}); None
    where the profiler saw no device activity in three tries (a trace now
    and then comes back empty). The profiler now and then loses a record
    of a kernel: its ms a call is per_call_ms's, while the launches stay as
    seen; a trace_marker at each end of the trace takes the records it
    loses there, and is left out. Cold: the L2 flushed before each call,
    its kernels left out."""
    from torch.profiler import ProfilerActivity, profile
    from abc_tpu_torch.ops.modarith import CHAIN_PREFIX
    skip = kernels_of(trace_marker) | \
        (kernels_of(l2_flush) if cold else set())
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trace_marker()
            for _ in range(reps):
                if cold:
                    l2_flush()
                fn()
            torch.cuda.synchronize()
            trace_marker()
        total, counts, launches = {}, {}, 0
        for ev in prof.events():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "memcpy" in ev.name.lower() or "memset" in ev.name.lower() \
                    or ev.name.startswith(CHAIN_PREFIX) or ev.name in skip:
                continue
            launches += 1
            total[ev.name] = total.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
            counts[ev.name] = counts.get(ev.name, 0) + 1 / reps
        if launches:
            by_name = per_call_ms(total, counts, reps)
            return sum(by_name.values()), launches / reps, by_name, counts
    return None


def chain_profile(fn, reps=3):
    """Device time of eager fn() per named elementwise chain, per call:
    {chain: [ms, kernels]} and the number of device kernels in the profile.
    A kernel belongs to the innermost ops/modarith.chain_range that was open
    when it was launched (matched through the launch call of the same
    correlation id); the hand-written NTT kernels are one row of their own,
    kernels launched outside every range another, and kernels whose launch
    call the profiler did not record a third (it loses events on long eager
    runs), so that the rows always add up to the kernels seen."""
    from torch.profiler import ProfilerActivity, profile
    from abc_tpu_torch.ops.modarith import CHAIN_PREFIX
    on_card = torch.autograd.DeviceType.CUDA
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    ranges = [(ev.time_range.start, ev.time_range.end, ev.name[len(
        CHAIN_PREFIX):]) for ev in events
        if ev.device_type != on_card and ev.name.startswith(CHAIN_PREFIX)]
    launched_at = {ev.id: ev.time_range.start for ev in events
                   if ev.device_type != on_card
                   and ev.name.startswith(("cudaLaunch", "cuLaunch"))}
    table, kernels = {}, 0
    for ev in events:
        if ev.device_type != on_card or ev.name.startswith(CHAIN_PREFIX) \
                or "memcpy" in ev.name.lower() or "memset" in ev.name.lower():
            continue
        kernels += 1
        at = launched_at.get(ev.id)
        if "ntt_" in ev.name:
            where = "NTT kernels"
        elif at is None:
            where = "(launch not recorded)"
        else:
            inside = [r for r in ranges if r[0] <= at <= r[1]]
            where = min(inside, key=lambda r: r[1] - r[0])[2] if inside \
                else "(outside the ranges)"
        row = table.setdefault(where, [0.0, 0.0])
        row[0] += ev.device_time_total / 1e3 / reps
        row[1] += 1 / reps
    return table, kernels / reps, len(ranges) / reps


def check_in_ranges(chains, what):
    """Every kernel of a chain_profile ran inside a named chain or is a
    hand-written NTT kernel: none is left "outside the ranges"."""
    outside = chains[0].get("(outside the ranges)")
    check(outside is None, f"{what}: kernels outside every named chain "
          f"(ms, kernels a call): {outside}; all chains: {chains[0]}")


def fmt_chains(chains, expect_kernels):
    """The per-chain table on one line, largest first, and whether its
    kernels add up to what one op launches."""
    table, kernels, n_ranges = chains
    total = sum(ms for ms, _ in table.values())
    rows = "; ".join(f"{name} {ms:.4f} ms ({100 * ms / total:.1f}%) in "
                     f"{count:.1f}" for name, (ms, count) in sorted(
                         table.items(), key=lambda kv: -kv[1][0]))
    lost = table.get("(launch not recorded)", [0.0, 0.0])[1]
    return (f"{total:.4f} ms in {kernels:.1f} kernels per op under "
            f"{n_ranges:.0f} ranges ({expect_kernels} kernels expected; "
            f"{lost:.1f} without a launch record): {rows}")


def fmt(prof):
    if prof is None:
        return "not measured"
    return f"{prof[0]:.4f} ms in {prof[1]:g} kernels"


def fmt_ntt(prof):
    """fmt plus the share of the hand-written NTT kernels."""
    if prof is None:
        return "not measured"
    ntt = sum(v for name, v in prof[2].items() if "ntt_" in name)
    count = sum(c for name, c in prof[3].items() if "ntt_" in name)
    return f"{fmt(prof)}, of which NTT {ntt:.4f} ms in {count:.0f}"


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def check_launched(launches, what, regenerates=False, absent=()):
    """Every kernel of `launches` launched at least once, but rns_uniform
    where the path regenerates no uniform key half (a fresh context draws
    its public key's inside ksk_compose): only a context restored from
    files without those halves calls it; and but the kernels `absent`
    names, which the path does not run (its caller says why)."""
    check(all(v > 0 for k, v in launches.items()
              if (regenerates or k != "rns_uniform") and k not in absent),
          f"{what} launched a kernel no time: {launches}")


# a BFV key switch always ends in a tail (relinearization, rotation), so
# the plain ks_mod_down runs on the CKKS rescale and a mesh's key switch
BFV_ABSENT = ("ks_mod_down",)


def _counters():
    from abc_tpu_torch.ops import behz_kernels as bk
    from abc_tpu_torch.ops import elementwise_kernels as ew
    from abc_tpu_torch.ops import keyswitch_kernels as kk
    from abc_tpu_torch.ops import mesh_kernels as mk
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.ops import rlwe_kernels as rk
    return (nk.launches, bk.launches, kk.launches, rk.launches, ew.launches,
            mk.launches)


def launch_counts():
    """Launches of every hand-written kernel of the main paths, by kernel:
    the NTT, BEHZ, key-switch, key generation / encryption / decryption,
    elementwise and mesh kernels' counts (ops/ntt_kernels.py,
    ops/behz_kernels.py, ops/keyswitch_kernels.py, ops/rlwe_kernels.py,
    ops/elementwise_kernels.py, ops/mesh_kernels.py)."""
    return {k: v for counts in _counters() for k, v in counts.items()}


def zero_launches():
    """Sets the counts of launch_counts() to 0."""
    for counts in _counters():
        for name in counts:
            counts[name] = 0


def since(before):
    """launch_counts() minus an earlier reading."""
    return {k: v - before[k] for k, v in launch_counts().items()}


def hand_written(kernels):
    """({counter: launches}, {other kernel: launches}) of {kernel name:
    launches}: a kernel counts for the longest counter name it holds
    (ks_mod_down_relin_kernel<1> for ks_mod_down_relin, not for
    ks_mod_down); a kernel that holds none is not hand-written (a library
    or torch kernel)."""
    names = sorted(launch_counts(), key=len, reverse=True)
    seen, other = dict.fromkeys(names, 0), {}
    for kernel, c in kernels.items():
        name = next((nm for nm in names if nm in kernel), None)
        if name is None:
            other[kernel] = c
        else:
            seen[name] += c
    return seen, other


# one node of cudaGraphDebugDotPrint's text: its type, then (a kernel node)
# "{ID | <id> (topoId: <t>) | <mangled symbol>\<\<\<grid,block,smem\>\>\>}"
_DOT_NODE = re.compile(
    r'^"graph_\d+_node_\d+"\[[^\n]*?label="\{(\w+)(.*?)\}"\];$', re.M | re.S)
_DOT_KERNEL = re.compile(r"\{ID \|[^|]*\| ([^\s|}\\]+)")


def dot_nodes(text):
    """({kernel name: nodes}, {other node type: nodes}) of a graph's
    cudaGraphDebugDotPrint text: a kernel node by its mangled symbol, any
    other node (MEMSET, MEMCPY, ...) by its type."""
    kernels, others = {}, {}
    for kind, body in _DOT_NODE.findall(text):
        if kind == "KERNEL":
            name = _DOT_KERNEL.search(body)
            check(name is not None, f"a kernel node without a name: {body!r}")
            kernels[name.group(1)] = kernels.get(name.group(1), 0) + 1
        else:
            others[kind] = others.get(kind, 0) + 1
    return kernels, others


def graph_nodes(g):
    """dot_nodes of a captured CUDA graph, read from its own node list
    (CUDAGraph.debug_dump, cudaGraphDebugDotPrint; the port's graphs keep
    their cudaGraph_t): what every replay launches. torch.profiler is no
    census of a replay: it drops kernel records, and on an H100 80GB HBM3
    at 700 W three profiles in a row of one replay held none."""
    import warnings
    from abc_tpu_torch.ops import _build
    path = os.path.join(_build.BUILD_DIR, "graph_nodes.dot")
    if os.path.exists(path):
        os.remove(path)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="DEBUG: calling")
        g.debug_dump(path)
    check(os.path.exists(path), "a graph's node list was not written "
          "(captured without keep_graph=True?)")
    with open(path) as f:
        text = f.read()
    os.remove(path)
    kernels, others = dot_nodes(text)
    check(kernels, f"a graph's node list holds no kernel: {text[:300]!r}")
    return kernels, others


def graph_census(g, want, what):
    """The kernel nodes of graph g, whose hand-written kernels must be
    exactly `want`: (kernel nodes, {other kernel: nodes}, {other node type:
    nodes})."""
    kernels, others = graph_nodes(g)
    seen, other = hand_written(kernels)
    check(seen == want, f"{what} holds the hand-written kernels {seen}, "
          f"not {want}")
    return sum(kernels.values()), other, others


def busy_share(prof, ms):
    """A kernel_profile's device ms over a call's `ms`, or "not
    measured"."""
    return "not measured" if prof is None else f"{prof[0] / ms:.3f}"


def op_graph(ctx, op, x0, want):
    """op(x0) captured as a CUDA graph with ctx's caches emptied around the
    capture; its nodes must be the hand-written kernels `want` and no other
    kernel (graph_census), and its replay is timed: (kernel nodes, other
    nodes by type, ms per replay between CUDA events (median of 10),
    kernel_profile of a replay (None where the profiler saw nothing))."""
    from abc_tpu_torch.utils.timing import graph_of
    with ctx.fresh_caches():
        g = graph_of(op, x0)
    kernels, other, others = graph_census(g, want, "a replay of the op")
    check(not other, f"a replay of the op runs kernels that are not "
          f"hand-written: {other}")
    return kernels, others, cuda_ms(g.replay), kernel_profile(g.replay)


def digest(t):
    """SHA-256 of a tensor's uint32 words, little-endian, C order (the
    recipe of abc_tpu_torch/testdata/golden.json)."""
    from abc_tpu_torch.ops.modarith import to_host
    words = np.ascontiguousarray(to_host(t.contiguous()), dtype="<u4")
    return hashlib.sha256(words.tobytes()).hexdigest()


def golden():
    import abc_tpu_torch
    path = os.path.join(os.path.dirname(abc_tpu_torch.__file__), "testdata",
                        "golden.json")
    with open(path) as f:
        return json.load(f)


def bound(n_bytes, imads, int_ops=0):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate, the multiply-adds over their pipe's
    rate (IMAD_S) and all integer operations, the multiply-adds and
    `int_ops` others, over the SM's issue rate (INT_ISSUE_S)."""
    by_bytes = n_bytes / HBM_BYTES_S * 1e3
    by_ops = max(imads / IMAD_S, (imads + int_ops) / INT_ISSUE_S) * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def ntt_bound(n, L, rows, inverse):
    """Bound of one transform launch: rows in and out, the [L, n] twiddle
    and companion tables and q (and n^-1 with its companion) read once;
    n/2 log2(n) butterflies per row, and the n^-1 scale of the inverse."""
    n_bytes = 4 * (2 * rows * n + 2 * L * n + L + (2 * L if inverse else 0))
    products = rows * ((n // 2) * (n.bit_length() - 1) + (n if inverse else 0))
    return bound(n_bytes, IMAD_PER_BUTTERFLY * products)


def rand_residues(moduli, shape, seed, device):
    from abc_tpu_torch.ops.modarith import as_residues
    q = np.asarray(moduli, dtype=np.uint64).reshape(len(moduli), 1)
    rng = np.random.default_rng(seed)
    return as_residues(rng.integers(0, q, size=shape, dtype=np.uint64),
                       device)


def _transforms(nk, ctx, x):
    """{kernel name: (kernel call, plain call)} on input x."""
    return {
        "ntt_fwd": (lambda: nk.ntt_fwd(x, ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh),
                    lambda: nk.fwd_ntt_plain(x, ctx.q, ctx.fwd_tw)),
        "ntt_inv": (lambda: nk.ntt_inv(x, ctx.q, ctx.inv_tw, ctx.inv_tw_sh,
                                       ctx.n_inv, ctx.n_inv_sh),
                    lambda: nk.inv_ntt_plain(x, ctx.q, ctx.inv_tw,
                                             ctx.n_inv)),
    }


def phase_kernels(dev):
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.ops import ntt_kernels as nk

    stats = {k: {"max_abs_err": 0} for k in nk.launches}

    def hold(name, got, want, at):
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        check(torch.equal(got, want), f"{name} != plain at {at}")

    # every n x rows, with 0 and q-1 among the inputs
    clusters = {}
    for n in SWEEP_N:
        seen = []
        for rows, L in SWEEP_ROWS:
            moduli = gen_ntt_primes(30, L, n)
            ctx = NttContext(n, moduli, dev)
            x = rand_residues(moduli, (rows // L, L, n), seed=n + rows,
                              device=dev)
            x[..., 0] = 0
            x[..., 1::257] = (ctx.q - 1).reshape(L, 1)
            for name, (kern, plain) in _transforms(nk, ctx, x).items():
                hold(name, kern(), plain(), (n, rows))
            back = ctx.inv(ctx.fwd(x))
            check(torch.equal(back, x), f"inv(fwd(x)) != x at {n, rows}")
            c = nk.cluster_size(rows, n)
            clusters[c] = clusters.get(c, 0) + 1
            seen.append(f"{rows}:{c}")
        print(f"  n={n}: ntt_fwd, ntt_inv = plain and inv(fwd(x)) = x at "
              f"rows:CTAs-per-row {' '.join(seen)}", flush=True)
    check(set(clusters) == {1, 2, 4, 8},
          f"cluster sizes launched: {clusters}")
    # the launch shapes of a batched mult+relin (the bench's curve)
    seen = []
    for B in BATCH_SIZES:
        for rows, L in BATCH_ROWS:
            moduli = gen_ntt_primes(30, L, MAIN_N)
            ctx = NttContext(MAIN_N, moduli, dev)
            x = rand_residues(moduli, (B * rows // L, L, MAIN_N),
                              seed=B + rows, device=dev)
            x[..., 0] = 0
            x[..., 1::257] = (ctx.q - 1).reshape(L, 1)
            for name, (kern, plain) in _transforms(nk, ctx, x).items():
                hold(name, kern(), plain(), (MAIN_N, B * rows))
            seen.append(f"{B * rows}:{nk.cluster_size(B * rows, MAIN_N)}")
    print(f"  n={MAIN_N}, batched mult+relin shapes (B in {BATCH_SIZES}): "
          f"ntt_fwd, ntt_inv = plain at rows:CTAs-per-row {' '.join(seen)}",
          flush=True)
    ctas = {rows: rows * nk.cluster_size(rows, MAIN_N) for rows in MAIN_ROWS}
    check(min(ctas.values()) >= 96, f"main-path launches on {ctas} CTAs")
    print(f"  shapes per cluster size {clusters}; main-path launches "
          f"(n={MAIN_N}) rows -> CTAs {ctas}", flush=True)

    # times at the main path's launch shapes and the ablation's
    for n, L, batch in NTT_SHAPES:
        moduli = gen_ntt_primes(30, L, n)
        ctx = NttContext(n, moduli, dev)
        x = rand_residues(moduli, (batch, L, n), seed=n + L + batch,
                          device=dev)
        rows = L * batch
        line = [f"n={n} L={L} batch={batch} ({rows} rows x "
                f"{nk.cluster_size(rows, n)} CTAs):"]
        for name, (kern, plain) in _transforms(nk, ctx, x).items():
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            prof = kernel_profile(kern)
            b_ms, b_by = ntt_bound(n, L, rows, name == "ntt_inv")
            line.append(f"{name} {ms:.4f} ms (plain {plain_ms:.4f} ms) "
                        f"[device: {fmt(prof)}; bound {b_ms:.5f} ms by "
                        f"{b_by}]")
            if JSON_SHAPE[name] == (n, L, batch):
                plain_prof = kernel_profile(plain)
                cold_ms, cold = cuda_ms(kern, cold=True), \
                    kernel_profile(kern, cold=True)
                stats[name].update(
                    ms=ms, plain_ms=plain_ms, device_ms=prof and prof[0],
                    plain_device_ms=plain_prof and plain_prof[0],
                    cold_ms=cold_ms, cold_device_ms=cold and cold[0],
                    bound_ms=b_ms, bound_by=b_by)
                line.append(f"[plain device: {fmt(plain_prof)}; cold L2 "
                            f"{cold_ms:.4f} ms, device {fmt(cold)}]")
        print("  " + "  ".join(line), flush=True)
    return stats


def behz_imads(kernel, K, D):
    """Integer multiply-adds per coefficient of one row of a BEHZ kernel,
    counted from csrc/behz.cu's own arithmetic (BEHZ_IMAD): K source
    residues, D destinations, each conversion sum reduced once per 16
    products and at its end. behz_tensor counts one limb."""
    w, sh, red = (BEHZ_IMAD[k] for k in ("wide", "shoup", "reduce64"))

    def conv(terms):                  # one destination's sum of products
        return terms * w + -(-terms // 16) * red

    if kernel == "behz_to_bsk":
        # per source y_i and its term mod m~; r; per destination the sum
        # with (q mod b_d)·r_b as one more term, times m~^-1
        return K * (sh + 1) + 1 + D * (conv(K + 1) + sh)
    if kernel == "behz_fast_floor":
        # per source t·qhat_i^-1·e_i; per destination the sum with (t mod
        # b_d)·e_bsk as one more term, times q^-1
        return K * sh + D * (conv(K + 1) + sh)
    if kernel == "behz_from_bsk":
        # per source y_i and its term mod m_sk, that sum reduced; alpha; per
        # destination the sum with (B mod q_j)·(q_j - a) as one more term
        return K * (sh + w) + -(-K // 16) * red + sh + D * conv(K + 1)
    # behz_tensor: four products (one of them a multiply-add), three reduce64
    return 4 * w + 3 * red


def words(out):
    """A kernel's output as one tensor: a tuple (behz_tensor's bases)
    flattened and joined."""
    if isinstance(out, tuple):
        return torch.cat([t.reshape(-1) for t in out])
    return out


def dec_words(out):
    """bfv_dec_round's (m, flag) as one tensor: m's words, then 1 if any
    word of the flag is set, else 0 (the kernel's flag has a word a block,
    the plain version's one)."""
    m, flag = out
    return torch.cat([m.reshape(-1),
                      (flag != 0).any().to(torch.int32).reshape(1)])


def behz_calls(bz, batch, edge, dev):
    """{kernel name: (kernel call, plain call, bytes, integer
    multiply-adds)} for the BEHZ kernels at one shape: the operands of one
    mult+relin of `batch` ciphertexts (one ciphertext: no batch axis), with
    0 and q-1 among random residues, or all 0 / all q-1 (`edge`). The bound
    counts each operand and result once, the tables once, and the
    operations of the kernel's own arithmetic (behz_imads)."""
    from abc_tpu_torch.ops import behz_kernels as bk
    L, n, K = bz.params.L, bz.params.n, len(bz.bsk)
    qs, bsk = bz.params.data_primes, bz.bsk
    lead = () if batch == 1 else (batch,)

    def operand(moduli, comps, seed):
        if edge is None:
            x = rand_residues(moduli, lead + (comps, len(moduli), n), seed,
                              dev)
            x[..., 0] = 0
            x[..., 1::257] = (torch.tensor(moduli, dtype=torch.int64) - 1
                              ).to(torch.int32).reshape(-1, 1).to(dev)
            return x
        q = torch.tensor(moduli, dtype=torch.int64).reshape(-1, 1)
        x = torch.zeros(lead + (comps, len(moduli), n), dtype=torch.int64)
        return (x + (q - 1 if edge == "max" else 0)).to(torch.int32).to(dev)

    def table_bytes(*tabs):
        return sum(t.numel() * t.element_size() for t in tabs)

    x = operand(qs, 2, 1)
    e_q, e_b = operand(qs, 3, 2), operand(bsk, 3, 3)
    bases = ((operand(qs, 2, 4), operand(qs, 2, 5), bz.ntt_q.q_col,
              bz.ntt_q.ratio),
             (operand(bsk, 2, 6), operand(bsk, 2, 7), bz.ntt_bsk.q_col,
              bz.ntt_bsk.ratio))
    T = bz.kernel_tab
    calls = {
        "behz_to_bsk": (lambda: bk.behz_to_bsk(x, T["to_bsk"], K),
                        lambda: bz._to_bsk_plain(x),
                        4 * batch * 2 * n * (L + K)
                        + table_bytes(T["to_bsk"]),
                        batch * 2 * n * behz_imads("behz_to_bsk", L, K))}
    # both bases in one launch, as BehzContext.multiply takes them
    calls["behz_tensor"] = (
        lambda: bk.behz_tensor(*bases),
        lambda: tuple(bk.tensor_plain(f1, f2, q) for f1, f2, q, _ in bases),
        4 * batch * n * 7 * (L + K)
        + table_bytes(*(t for b in bases for t in b[2:])),
        batch * (L + K) * n * behz_imads("behz_tensor", 2, 1))
    calls["behz_fast_floor"] = (
        lambda: bk.behz_fast_floor(e_q, e_b, T["fast_floor"]),
        lambda: bz._fast_floor_plain(e_q, e_b),
        4 * batch * 3 * n * (L + 2 * K) + table_bytes(T["fast_floor"]),
        batch * 3 * n * behz_imads("behz_fast_floor", L, K))
    calls["behz_from_bsk"] = (
        lambda: bk.behz_from_bsk(e_b, T["from_bsk"], L),
        lambda: bz._from_bsk_plain(e_b),
        4 * batch * 3 * n * (K + L) + table_bytes(T["from_bsk"]),
        batch * 3 * n * behz_imads("behz_from_bsk", K - 1, L))
    return calls


def behz_launch(table, name, L, K, batch, n):
    """The launch of a BEHZ kernel (abc_behz_launch_info) and what the
    compiler made of it (ops/kernel_census.kernel_table), on one line, and
    as a record."""
    from abc_tpu_torch.ops import behz_kernels as bk
    from abc_tpu_torch.ops import kernel_census as kc
    info = bk.launch_info(name, *kc.launch_of(name, L, K, batch), n)
    row = table.get(kc.launch_key(name, info), {})
    check(row, f"no ptxas / SASS record of {kc.launch_key(name, info)}")
    rec = {"kernel": kc.launch_key(name, info), **info, **row}
    return (f"[{rec['kernel']}: {info['threads']} threads x "
            f"{info['blocks']} blocks, {info['blocks_per_sm']} blocks "
            f"({info['warps_per_sm']} warps) an SM; "
            f"{kc.fmt_kernel(row)}]"), rec


def phase_behz(dev):
    """Phase 2b: every BEHZ kernel against its plain version at
    BEHZ_SHAPES and on edge inputs; times, launches and compiler census at
    BEHZ_SHAPES. Returns the kernels line's stats (the main path's
    shape)."""
    from abc_tpu_torch.crypto.behz import BehzContext
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.ops import _build
    from abc_tpu_torch.ops import kernel_census as kc

    table = kc.kernel_table(_build.build_log, _build.sass())
    check(len(table) >= 4, f"no ptxas / SASS record of the BEHZ kernels: "
          f"{sorted(table)}")
    stats = {name: {"max_abs_err": 0} for name in BEHZ}
    cases = [(shape, None) for shape in BEHZ_SHAPES] + \
        [(shape, edge) for shape in BEHZ_EDGE_SHAPES
         for edge in ("zero", "max")]
    for (n, L, batch, t_bits), edge in cases:
        params = kc.shape_params(n, L, t_bits)
        bz = BehzContext(params, NttContext(n, params.data_primes, dev))
        at = f"n={n} L={L} ciphertexts={batch}" + \
            (f" t={t_bits} bits" if t_bits else "") + \
            (f" all {'0' if edge == 'zero' else 'q-1'}" if edge else "")
        line = []
        for name, (kern, plain, n_bytes, imads) in behz_calls(
                bz, batch, edge, dev).items():
            got, want = words(kern()), words(plain())
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            check(torch.equal(got, want), f"{name} != plain at {at}")
            if edge is not None:
                continue
            st = {}
            launch, rec = behz_launch(table, name, L, len(bz.bsk), batch, n)
            line.append(f"{name} " + _timed(
                st, kern, plain, [n, L, batch], bound(n_bytes, imads))
                + " " + launch)
            if (n, L, batch, t_bits) == BEHZ_SHAPES[0]:
                stats[name].update(st, launch=rec)
        print(f"  {at}: every BEHZ kernel = plain"
              + ("" if not line else "; " + "; ".join(line)), flush=True)
    return stats


def ks_imads(name, R, A=0, K=1, k=1, Lo=0, halves=2):
    """Integer multiply-adds per coefficient of one row of a key-switch
    kernel's function, counted from csrc/keyswitch.cu's arithmetic
    (BEHZ_IMAD's costs): R columns, A digits of K sources (the lift), key
    halves (the contraction), k primes divided out of Lo + k rows (the mod
    switch down)."""
    w, sh, red = (BEHZ_IMAD[x] for x in ("wide", "shoup", "reduce64"))
    if name == "ks_decompose":
        # k = 1: conditional subtracts only; else per digit K products
        # y_i, and per column a sum of K products reduced
        return 0 if K == 1 else A * (K * sh + R * (K * w + -(-K // 16) *
                                                   red))
    if name == "ks_contract":
        # per column each half's sum of A products, reduced
        return R * halves * (A * w + -(-A // 16) * red)
    # ks_mod_down: every kept row divided k times, the specials below each
    # special once per step above them
    return (Lo * k + k * (k - 1) // 2) * sh


def ks_calls(scheme, n, L, k, batch, level, edge, dev):
    """{label: (kernel, kernel call, plain call, bytes, integer
    multiply-adds, launch shape, library call or None)} of the key-switch
    kernels at one shape (the launch shape: keyswitch_kernels.plan's
    keywords for ks_decompose and ks_contract, mod_down_plan's for
    ks_mod_down):
    the operands of one key switch of `batch` ciphertexts (one: no batch
    axis) at `level` of an (n, L data primes, k special primes) context,
    the digit lift, the contraction without and with a Galois permutation,
    a decryption's one-half contraction of the ciphertext's two components
    with [1, s] over the data primes at `level`, the mod switch down of both accumulators, and (CKKS below full level or
    at it) the rescale of a ciphertext; with 0 and q-1 among random
    residues, all 0 (`edge` "zero"), all q-1 ("max"), or the divided rows
    at p>>1 and (p>>1)+1 ("half"). The bound counts each operand and
    result once and the tables once, and the operations of ks_imads. The
    k = 1 lift is one torch.remainder (each residue below 2 q_r, primes of
    one size), the port never calls it; no single PyTorch call computes a
    base conversion, a modular contraction or an exact division by a
    prime."""
    from abc_tpu_torch.crypto.ckks import CkksParams
    from abc_tpu_torch.crypto.ntt import eval_perm_tables
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.ops import keyswitch_kernels as kk
    from abc_tpu_torch.ops.modarith import as_residues, ratio_table
    p = BfvParams.create(n, seed=11, ks_digits=k) if scheme == "bfv" else \
        CkksParams.create(n, levels=L, seed=3, ks_digits=k)
    check(p.L == L, f"{scheme} n={n}: L={p.L}")
    qs = p.data_primes[:level]
    cols = qs + p.special_primes
    R = len(cols)
    groups = [g for g in ([i for i in grp if i < level]
                          for grp in p.digit_groups) if g]
    A = len(groups)
    digits = None if k == 1 else kk.Digits(p.data_primes, groups, cols, k,
                                           dev)
    div, rdiv = kk.Division(cols, k, dev), kk.Division(qs, 1, dev)
    q = as_residues(np.asarray(cols, np.uint32).reshape(-1, 1), dev)
    ratio = ratio_table(cols, dev)
    e, pos = eval_perm_tables(n)
    perm = torch.from_numpy(pos[(e * 3) % (2 * n)]).to(dev)
    lead = () if batch == 1 else (batch,)

    def operand(moduli, shape, seed, divided=0):
        qcol = torch.tensor(moduli, dtype=torch.int64).reshape(-1, 1)
        if edge in ("zero", "max"):
            x = torch.zeros(shape + (len(moduli), n), dtype=torch.int64)
            return (x + (qcol - 1 if edge == "max" else 0)).to(
                torch.int32).to(dev)
        x = rand_residues(moduli, shape + (len(moduli), n), seed, dev)
        x[..., 0] = 0
        x[..., 1::257] = (qcol - 1).to(torch.int32).to(dev)
        if edge == "half":
            for r in range(len(moduli) - divided, len(moduli)):
                x[..., r, 0::2] = moduli[r] >> 1
                x[..., r, 1::2] = (moduli[r] >> 1) + 1
        return x

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    d = operand(qs, lead, 1)
    D = operand(cols, lead + (A,), 2)
    kb, ka = operand(cols, (A,), 3), operand(cols, (A,), 4)
    x = operand(cols, lead + (2,), 5, k)
    ct, sk = operand(qs, lead + (2,), 7), operand(qs, (2,), 8)
    qd = as_residues(np.asarray(qs, np.uint32).reshape(-1, 1), dev)
    rd = ratio_table(qs, dev)
    rows = batch
    tabs = (q, ratio) + (() if digits is None else (digits.words,))
    calls = {
        "ks_decompose": (
            "ks_decompose", lambda: kk.decompose(d, q, ratio, digits),
            lambda: kk.lift_plain(d, q) if digits is None else
            kk.decompose_plain(d, q, digits),
            4 * rows * n * (level + A * R) + nbytes(*tabs),
            rows * n * ks_imads("ks_decompose", R, A, k),
            dict(rows=rows, A=A, R=R, K=k),
            (lambda: torch.remainder(d.unsqueeze(-2), q)) if digits is None
            else None),
        "ks_contract": (
            "ks_contract", lambda: kk.contract(D, kb, ka, q, ratio),
            lambda: kk.contract_plain(D, kb, ka, q),
            4 * n * (rows * A * R + 2 * A * R + 2 * rows * R) + nbytes(q,
                                                                       ratio),
            rows * n * ks_imads("ks_contract", R, A),
            dict(rows=rows, A=A, R=R), None),
        "ks_contract+perm": (
            "ks_contract", lambda: kk.contract(D, kb, ka, q, ratio, perm),
            lambda: kk.contract_plain(D, kb, ka, q, perm),
            4 * n * (rows * A * R + 2 * A * R + 2 * rows * R)
            + nbytes(q, ratio, perm),
            rows * n * ks_imads("ks_contract", R, A),
            dict(rows=rows, A=A, R=R), None),
        "ks_contract/1": (
            "ks_contract", lambda: kk.contract(ct, sk, None, qd, rd),
            lambda: kk.contract_plain(ct, sk, None, qd),
            4 * n * level * (rows * 2 + 2 + rows) + nbytes(qd, rd),
            rows * n * ks_imads("ks_contract", level, 2, halves=1),
            dict(rows=rows, A=2, R=level, halves=1), None),
        "ks_mod_down": (
            "ks_mod_down", lambda: kk.mod_down(x, div),
            lambda: kk.mod_down_plain(x, div),
            4 * 2 * rows * n * (R + level) + nbytes(div.words),
            2 * rows * n * ks_imads("ks_mod_down", R, k=k, Lo=level),
            dict(rows=2 * rows, Lo=level, k=k), None)}
    if scheme == "ckks" and level > 1:
        r = operand(qs, (2,), 6, 1)
        calls["rescale"] = (
            "ks_mod_down", lambda: kk.mod_down(r, rdiv),
            lambda: kk.mod_down_plain(r, rdiv),
            4 * 2 * n * (2 * level - 1) + nbytes(rdiv.words),
            2 * n * ks_imads("ks_mod_down", level, k=1, Lo=level - 1),
            dict(rows=2, Lo=level - 1, k=1), None)
    return calls


def ks_split(name, info):
    """How a key-switch launch splits its work (keyswitch_kernels.plan,
    .mod_down_plan), for phase 2c's and 2e's lines."""
    if name == "ks_decompose":
        return (f", {info['cols']} columns a thread ({info['groups']} "
                f"groups), {info['sources']} sources held")
    if name == "ks_contract":
        return (f", {info['lanes']} lanes a quad"
                + (" (streaming)" if info["lanes"] == 1 else "")
                + f", {info['halves']} halves")
    return (f", {info['rows']} kept rows a thread, {info['arg0']} specials "
            "held")


def phase_keyswitch(dev):
    """Phase 2c: every key-switch kernel against its plain version at
    KS_SHAPES and on edge inputs; times, launches and compiler census at
    the timed shapes. Returns the kernels line's stats (the main path's
    shape)."""
    from abc_tpu_torch.ops import _build
    from abc_tpu_torch.ops import keyswitch_kernels as kk
    from abc_tpu_torch.ops import kernel_census as kc

    table = kc.kernel_table(_build.build_log, _build.sass(), prefix="ks_")
    check(len(table) >= 3, f"no ptxas / SASS record of the key-switch "
          f"kernels: {sorted(table)}")
    stats = {name: {"max_abs_err": 0} for name in KS}
    cases = [(shape, None) for shape in KS_SHAPES] + \
        [(shape, edge) for shape in KS_EDGE_SHAPES
         for edge in ("zero", "max", "half")]
    for (scheme, n, L, k, batch, level), edge in cases:
        at = f"{scheme} n={n} L={L} k={k} ciphertexts={batch} level={level}" \
            + (f" edge {edge}" if edge else "")
        line = []
        for label, (name, kern, plain, n_bytes, imads, lines, library) in \
                ks_calls(scheme, n, L, k, batch, level, edge, dev).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            check(torch.equal(got, want), f"{label} != plain at {at}")
            check(library is None or torch.equal(library(), got),
                  f"{label}'s library call != the kernel at {at}")
            if edge is not None or (scheme, n, L, k, batch, level) not in \
                    KS_TIMED:
                continue
            info = kk.mod_down_plan(name, n, **lines) \
                if name == "ks_mod_down" else kk.plan(name, n, **lines)
            key = kc.ks_launch_key(name, info)
            row = table.get(key, {})
            check(row, f"no ptxas / SASS record of {key}")
            st = {}
            line.append(
                f"{label} " + _timed(st, kern, plain, [n, L, k, batch, level],
                                     bound(n_bytes, imads), library)
                + f" [{key}: {info['threads']} threads x {info['blocks']} "
                f"blocks{ks_split(name, info)}, {info['blocks_per_sm']} "
                f"blocks ({info['warps_per_sm']} warps) an SM; "
                f"{kc.fmt_kernel(row)}]")
            if (scheme, n, L, k, batch, level) == KS_SHAPES[0] and \
                    label in KS:
                stats[name].update(st, launch={"kernel": key, **info, **row})
        print(f"  {at}: every key-switch kernel = plain"
              + ("" if not line else "; " + "; ".join(line)), flush=True)
    return stats


def rlwe_ops(name, L=0, target=None):
    """(multiply-add slots, other integer operations) per output word of a
    key generation, encryption or decryption kernel, counted from
    csrc/rlwe.cu's arithmetic: multiply-adds at BEHZ_IMAD's costs, one
    operation for each plain add, subtract, rotate, xor, select or compare.
    The Threefry block (THREEFRY_OPS, no multiply) and its reduce64 per
    drawn word; for ksk_compose also a·s and the two subtractions and,
    toward a target (`target` "relin": s², "galois": s read through the
    permutation, None: the public key), the Shoup product by the factor;
    for bfv_dec_round per coefficient L limbs of a Shoup product, two wide
    products and three adds, and the final rounding."""
    w, sh, red = (BEHZ_IMAD[x] for x in ("wide", "shoup", "reduce64"))
    if name == "rns_uniform":
        return np.array([red, THREEFRY_OPS])
    if name == "ksk_compose":
        imads = 2 * red + w + (sh if target else 0) + \
            ((w + red) if target == "relin" else 0)
        return np.array([imads, THREEFRY_OPS + 2])
    if name == "bfv_dec_round":
        return np.array([L * (sh + 2 * w), 3 * L + 4])
    return np.array([0, 3])   # rlwe_lift: the lift and two adds, a word


def boundary_residues(qs, tab, m, d):
    """Residues [L, 1] of an integer whose scale-and-round to t lies exactly
    d units of 2^-32 from the rounding boundary next to plaintext value m
    (the fraction of bfv_dec_round is 2^31 + d). The fixed-point sum
    truncates each limb's term, so integers next to each other in the
    exact fraction are tried in turn; needs at least three primes, so that
    neighbouring integers share the exact fraction."""
    from abc_tpu_torch.ops.modarith import to_host
    Q = 1
    for q in qs:
        Q *= q
    f_hi, f_lo = tab.f_hi.reshape(-1).tolist(), tab.f_lo.reshape(-1).tolist()
    qinv = [int(w) for w in to_host(tab.qinv).reshape(-1)]
    for shift in range(3 * len(qs) + 3):
        X0 = (Q * ((2 * m + 1) * (1 << 31) + d + shift)) // (tab.t << 32)
        for X in range(X0, X0 + 64):
            frac = 0
            for q, w, hi, lo in zip(qs, qinv, f_hi, f_lo):
                y = (X % q) * w % q
                frac += (y * hi & 0xFFFFFFFF) + (y * lo >> 32)
            if (frac & 0xFFFFFFFF) - (1 << 31) == d:
                return torch.tensor([[X % q] for q in qs],
                                    dtype=torch.int64).to(torch.int32)
    raise AssertionError(f"no integer at fraction offset {d}")


@functools.lru_cache(maxsize=None)
def rlwe_context(scheme, n, L, k, dev):
    """The context whose operands rlwe_calls reads, made once for all the
    cases and edges of one shape (phase 2d empties the cache)."""
    from abc_tpu_torch.crypto.bfv import BfvContext
    from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
    from abc_tpu_torch.crypto.params import BfvParams
    if scheme == "bfv":
        return BfvContext(BfvParams.create(n, seed=11, ks_digits=k), dev)
    return CkksContext(CkksParams.create(n, levels=L, seed=3, ks_digits=k),
                       dev)


def rlwe_calls(what, scheme, n, L, k, K, B, edge, dev):
    """{label: (kernel, kernel call, plain call, bytes, integer operations,
    output rows, library call or None)} of the key generation, encryption
    and decryption kernels at one case of RLWE_CASES, on the operands a
    context of those parameters gives them: "pk" the public key (its
    uniform half, its composition without a target term, the secret's and
    the error's lifts), "keys" K switching keys in one batch (their uniform
    halves, the errors' lift, the composition toward s² and Galois
    targets), "enc" the encryption of B ciphertexts (u's lift, and e's with
    the inverse transform's output and Δ·m), "dec" the scale-and-round;
    with 0 and q-1 among random residues, all 0 and key words 0 (`edge`
    "zero"), all q-1, key words 0xFFFFFFFF and lifts of ±19 ("max"), or
    (decryption) fractions exactly 2^31 + d for d in 0, ±4095, ±4096 next
    to m = t-1 and 3 ("half": the plain call also holds the flag and the
    rounding to what d gives). The bound counts each operand and result
    once, and the operations of rlwe_ops. Launch shape: (rows, limbs) as
    rlwe_kernels.launch_info takes them. The lift without base or message
    is one PyTorch call, torch.remainder(v[..., None, :], q) (int8 against
    an int32 [R, 1] column: canonical int32 residues), its library call;
    no single PyTorch call draws Threefry words, composes a key, lifts with
    the encryption's adds or rounds by this fixed-point sum."""
    from abc_tpu_torch.ops import rlwe_kernels as rk
    from abc_tpu_torch.ops.modarith import as_residues
    ctx = rlwe_context(scheme, n, L, k, dev)
    p = ctx.params
    check(p.L == L, f"{scheme} n={n}: L={p.L}")
    rng = np.random.default_rng(n + L + K + B)

    def residues(moduli, lead, seed):
        qcol = torch.tensor(moduli, dtype=torch.int64).reshape(-1, 1)
        shape = tuple(lead) + (len(moduli), n)
        if edge in ("zero", "max"):
            x = torch.zeros(shape, dtype=torch.int64)
            return (x + (qcol - 1 if edge == "max" else 0)).to(
                torch.int32).to(dev)
        x = rand_residues(moduli, shape, seed, dev)
        x[..., 0] = 0
        x[..., 1::257] = (qcol - 1).to(torch.int32).to(dev)
        return x

    def small(shape, low=-19, high=20):
        if edge == "zero":
            v = np.zeros(shape, dtype=np.int8)
        elif edge == "max":
            v = np.where(np.arange(shape[-1]) % 2, 19, -19) * \
                np.ones(shape, dtype=int)
        else:
            v = rng.integers(low, high, size=shape)
            v.reshape(-1)[:3] = [max(low, -19), min(high - 1, 19), 0]
        return torch.from_numpy(v.astype(np.int8)).to(dev)

    def words_of(count):
        if edge == "zero":
            return torch.zeros((count, 2), dtype=torch.int32, device=dev)
        if edge == "max":
            return torch.full((count, 2), -1, dtype=torch.int32, device=dev)
        return as_residues(rng.integers(0, 1 << 32, size=(count, 2),
                                        dtype=np.uint64), dev)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts if t is not None)

    def lift_call(v, qv):
        """The lift alone of v over qv's moduli, and its library call."""
        return ("rlwe_lift", lambda: rk.rlwe_lift(v, qv),
                lambda: rk.rlwe_lift_plain(v, qv),
                v.numel() + 4 * v.numel() * qv.shape[0] + nbytes(qv),
                v.numel() * qv.shape[0] * rlwe_ops("rlwe_lift"),
                (v.numel() // n, qv.shape[0]),
                lambda: torch.remainder(v[..., None, :], qv))

    qs, full = p.data_primes, p.coeff_modulus
    q_q, ratio_q = ctx.ntt_q.q_col, ctx.ntt_q.ratio
    q_f, ratio_f = ctx.ntt_qp.q_col, ctx.ntt_qp.ratio
    calls = {}
    if what in ("pk", "keys"):
        s = residues(full, (), 7) if edge else ctx.s_ntt_full
        if what == "pk":
            A, R, q, ratio = 1, L, q_q, ratio_q
            keys = words_of(1).reshape(1, 1, 2)
            fac = target = perms = None
            lifts = {"lift_secret": (small((n,), -1, 2), q_f),
                     "lift_error": (small((n,)), q_q)}
        else:
            A, R, q, ratio = p.num_ks_digits, len(full), q_f, ratio_f
            keys = words_of(K * A).reshape(K, A, 2)
            ids = ["relin"] + [f"galois_{pow(3, j, 2 * n)}"
                               for j in range(1, K)]
            fac = ctx._ks_fac
            target = torch.tensor([-1] + list(range(K - 1)),
                                  dtype=torch.int32, device=dev)
            perms = torch.stack([ctx._galois_perm_eval(int(i[7:]))
                                 for i in ids[1:]]) if K > 1 else None
            lifts = {"lift_errors": (small((K, A, n)), q_f)}
        e = residues(qs if what == "pk" else full, (K or 1, A), 8)
        rows = (K or 1) * A
        calls["rns_uniform"] = (
            "rns_uniform", lambda: rk.rns_uniform(keys, q, ratio, n),
            lambda: rk.rns_uniform_plain(keys, q, n),
            4 * rows * R * n + nbytes(keys, q, ratio),
            rows * R * n * rlwe_ops("rns_uniform"), (rows, R), None)
        calls["ksk_compose"] = (
            "ksk_compose",
            lambda: rk.ksk_compose(keys, e, s, q, ratio, fac, target, perms),
            lambda: rk.ksk_compose_plain(keys, e, s, q, fac, target, perms),
            3 * 4 * rows * R * n + 4 * R * n
            + nbytes(keys, q, ratio, fac, target, perms),
            R * n * A * sum(rlwe_ops("ksk_compose", target=(
                None if fac is None else "relin" if j == 0 else "galois"))
                for j in range(K or 1)), (rows, R), None)
        for label, (v, qv) in lifts.items():
            calls[label] = lift_call(v, qv)
    if what == "enc":
        base = residues(qs, (B, 2), 9)
        e = small((B, 2, n))
        u = small((B, n), -1, 2)
        if scheme == "bfv":
            t = p.plain_modulus
            m = torch.from_numpy(rng.integers(0, t, size=(B, n))).to(
                torch.int32).to(dev)
            if edge == "max":
                m.fill_(t - 1)
            elif edge == "zero":
                m.zero_()
            delta, times = ctx._delta, BEHZ_IMAD["shoup"]
        else:                                   # CKKS: plaintext rows
            m, delta, times = residues(qs, (B,), 12), None, 0
        calls["lift_encrypt"] = (
            "rlwe_lift",
            lambda: rk.rlwe_lift(e, q_q, base, m, delta),
            lambda: rk.rlwe_lift_plain(e, q_q, base, m, delta),
            e.numel() + 2 * 4 * B * 2 * L * n + nbytes(m, delta, q_q),
            B * 2 * L * n * rlwe_ops("rlwe_lift")
            + B * L * n * np.array([times, 1]), (B * 2, L), None)
        calls["lift_u"] = lift_call(u, q_q)
    if what == "dec":
        tab = ctx._dec_round

        def flagged(out):
            return out[0], out[1].to(torch.int32).reshape(1)

        def dec_call(label, v, want=None):
            def plain():
                got = flagged(rk.bfv_dec_round_plain(v, tab))
                if want is not None:
                    check((bool(got[1]), int(got[0][1])) == want,
                          f"{label}: flag and value {bool(got[1])}, "
                          f"{int(got[0][1])}, not {want}")
                return got
            calls[label] = (
                "bfv_dec_round", lambda: rk.bfv_dec_round(v, tab), plain,
                4 * (L + 1) * n + nbytes(tab.words),
                n * rlwe_ops("bfv_dec_round", L), (1, L), None)

        if edge == "half":
            t = p.plain_modulus
            for d in (0, 4095, -4095, 4096, -4096):
                for mv in (t - 1, 3):
                    v = torch.zeros((L, n), dtype=torch.int32)
                    v[:, 1:2] = boundary_residues(qs, tab, mv, d)
                    dec_call(f"bfv_dec_round d={d:+d} m={mv}", v.to(dev),
                             (abs(d) < 4096, (mv + 1) % t if d >= 0 else mv))
        else:
            dec_call("bfv_dec_round", residues(qs, (), 10))
    return calls


def dec_round_flags(dev):
    """On the card, through rk.bfv_dec_round on one table: a flagged call
    (a coefficient 4095 units of 2^-32 from the rounding boundary), then
    an unflagged one (4096 units), both read after the second ran; each
    flag and word as the plain call gives them. Then one call captured in
    a CUDA graph: its node
    list must be one bfv_dec_round kernel and no other node (no memset),
    and replays of it alternately on flagged and unflagged words read as
    the plain calls."""
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.ops import rlwe_kernels as rk
    from abc_tpu_torch.utils.timing import graph_of
    p = BfvParams.create(16384, seed=11)
    qs, t = p.data_primes, p.plain_modulus
    tab = rk.DecRound(qs, t, dev)
    vs = {}
    for flagged, (mv, d) in ((True, (t - 1, 4095)), (False, (3, -4096))):
        v = torch.zeros((len(qs), p.n), dtype=torch.int32)
        v[:, 1:2] = boundary_residues(qs, tab, mv, d)
        v[:, -1:] = boundary_residues(qs, tab, 3, 4096)
        vs[flagged] = v.to(dev)
    got = [rk.bfv_dec_round(vs[True], tab), rk.bfv_dec_round(vs[False], tab)]
    torch.cuda.synchronize()
    for (m, flag), flagged in zip(got, (True, False)):
        want_m, want_flag = rk.bfv_dec_round_plain(vs[flagged], tab)
        check(torch.equal(m, want_m) and bool(flag.any()) == flagged
              == bool(want_flag), f"bfv_dec_round's {'un' * (not flagged)}"
              f"flagged call read flag {flag.tolist()} (words equal: "
              f"{torch.equal(m, want_m)})")
    x = vs[True].clone()
    g = graph_of(lambda y: rk.bfv_dec_round(y, tab), x)
    want = {**{nm: 0 for nm in launch_counts()}, "bfv_dec_round": 1}
    kernels, other, others = graph_census(
        g, want, "a graph of one bfv_dec_round call")
    check(kernels == 1 and not other and not others,
          f"a graph of one bfv_dec_round call holds {kernels} kernel nodes, "
          f"other kernels {other} and other nodes {others}")
    for flagged in (False, True, False):
        x.copy_(vs[flagged])
        g.replay()
        torch.cuda.synchronize()
        want_m, want_flag = rk.bfv_dec_round_plain(vs[flagged], tab)
        check(torch.equal(g.output[0], want_m)
              and bool(g.output[1].any()) == bool(want_flag) == flagged,
              f"a replay of bfv_dec_round on {'un' * (not flagged)}flagged "
              f"words read flag {g.output[1].tolist()}")
    return f"flagged then unflagged, one kernel node a graph ({others})"


def phase_rlwe(dev):
    """Phase 2d: every key generation, encryption and decryption kernel
    against its plain version at RLWE_CASES and on edge inputs (the plain
    lifts also against their library call); times, launches and compiler
    census at the timed cases; no 64-bit division or remainder routine
    (SASS CALL) and no spill in any instantiation of rlwe_lift and
    bfv_dec_round; a flagged then an unflagged bfv_dec_round, and a graph of
    one (dec_round_flags). Returns the kernels line's stats (RLWE_JSON's
    cases)."""
    from abc_tpu_torch.ops import _build
    from abc_tpu_torch.ops import kernel_census as kc
    from abc_tpu_torch.ops import rlwe_kernels as rk

    table = kc.kernel_table(_build.build_log, _build.sass(), prefix=kc.RLWE)
    check(len(table) >= 4, f"no ptxas / SASS record of the rlwe kernels: "
          f"{sorted(table)}")
    for key, row in table.items():
        if key.startswith(("rlwe_lift", "bfv_dec_round")):
            check(row.get("CALL") == 0 and row.get("spill_stores") == 0
                  and row.get("spill_loads") == 0,
                  f"{key}: SASS CALL {row.get('CALL')}, spills "
                  f"{row.get('spill_stores')}/{row.get('spill_loads')} B")
    print("  rlwe_lift, bfv_dec_round: " + "; ".join(
        f"{key} {kc.fmt_kernel(row)}" for key, row in table.items()
        if key.startswith(("rlwe_lift", "bfv_dec_round"))), flush=True)
    stats = {name: {"max_abs_err": 0} for name in RLWE}
    cases = [(case, None) for case in RLWE_CASES] + \
        [(case, edge) for case in RLWE_EDGE_CASES for edge in ("zero", "max")
         + (("half",) if case[0] == "dec" else ())]
    for case, edge in cases:
        what, scheme, n, L, k, K, B = case
        at = f"{what} {scheme} n={n} L={L} k={k} keys={K} " \
            f"ciphertexts={B}" + (f" edge {edge}" if edge else "")
        line = []
        for label, (name, kern, plain, n_bytes, ops, shape, library) in \
                rlwe_calls(*case, edge, dev).items():
            read = dec_words if name == "bfv_dec_round" else words
            got, want = read(kern()), read(plain())
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            check(torch.equal(got, want), f"{label} != plain at {at}")
            check(library is None or torch.equal(library(), got),
                  f"{label}'s library call != the kernel at {at}")
            if edge is not None or case not in RLWE_TIMED:
                continue
            info = rk.launch_info(name, *shape, n)
            key = kc.rlwe_launch_key(name, info)
            row = table.get(key, {})
            check(row, f"no ptxas / SASS record of {key}")
            st = {}
            line.append(
                f"{label} " + _timed(st, kern, plain, list(case),
                                     bound(n_bytes, *ops), library)
                + f" [{key}: {info['threads']} threads x {info['blocks']} "
                f"blocks, {info['blocks_per_sm']} blocks "
                f"({info['warps_per_sm']} warps) an SM; "
                f"{kc.fmt_kernel(row)}]")
            if RLWE_JSON[name] == (case, label):
                stats[name].update(st, launch={"kernel": key, **info, **row})
        print(f"  {at}: every rlwe kernel = plain"
              + ("" if not line else "; " + "; ".join(line)), flush=True)
    rlwe_context.cache_clear()
    print(f"  bfv_dec_round: {dec_round_flags(dev)}", flush=True)
    return stats


# phase 2e times the K9 kernels at these of phase 2c's shapes: one
# ciphertext and B=64 at k=1, k=2, LaplaceSharpening's (16384, 13), and
# CKKS at full level, and holds them to plain on all-0 and all-(q-1) inputs
# at every one of them and at k=2 B=64; the kernels line reads the first
K9_TIMED = [KS_SHAPES[0], KS_SHAPES[1], KS_SHAPES[2], KS_SHAPES[4],
            KS_SHAPES[5]]
K9_EDGE_SHAPES = KS_SHAPES[:6]
# runs of each of phase 2e's dependent chains, eager and replayed
CHAIN_STRESS_RUNS = 200


def k9_calls(scheme, n, L, k, batch, level, edge, dev):
    """{label: (kernel, kernel call, plain call, bytes, integer
    multiply-adds, launch shape, library call or None)} of the K9 kernels
    at one of phase 2c's shapes (`batch` ciphertexts at `level` of an (n, L
    data primes, k special primes) context): ks_mod_down with the
    relinearization's tail (both halves of a key switch and a size-3
    product), with the rotation's at Galois elements 3 and 2n-1 (both
    signs occur in each; the rotation's sources computed from g^-1), and
    each elementwise op on [batch, 2, level, n]
    ciphertexts: add and sub of two, the plaintext product (mul by
    [level, n]), neg, the CKKS integer multiply (mul by a column), and the
    component-0 forms of add_plain and sub_from_plain (a plaintext's
    coefficients times a column); with 0 and q-1 among random residues,
    all 0 (`edge` "zero") or all q-1 ("max"). The bound counts each operand
    and result once and the tables once, and the multiply-adds of
    ks_imads for the division and of a 32x32 product reduced by reduce64
    for each product mod q. The launch shape: keyswitch_kernels.
    mod_down_plan's keywords for the mod down, the output rows for an
    elementwise op. No single PyTorch call computes a modular add, a
    product mod q or the fused tail."""
    from abc_tpu_torch.crypto.ckks import CkksParams
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.ops import elementwise_kernels as ew
    from abc_tpu_torch.ops import keyswitch_kernels as kk
    from abc_tpu_torch.ops.modarith import as_residues, ratio_table
    p = BfvParams.create(n, seed=11, ks_digits=k) if scheme == "bfv" else \
        CkksParams.create(n, levels=L, seed=3, ks_digits=k)
    check(p.L == L, f"{scheme} n={n}: L={p.L}")
    qs = p.data_primes[:level]
    cols = qs + p.special_primes
    R = len(cols)
    div = kk.Division(cols, k, dev)
    q = as_residues(np.asarray(qs, np.uint32).reshape(-1, 1), dev)
    ratio = ratio_table(qs, dev)
    lead = () if batch == 1 else (batch,)

    def operand(moduli, shape, seed):
        qcol = torch.tensor(moduli, dtype=torch.int64).reshape(-1, 1)
        if edge in ("zero", "max"):
            x = torch.zeros(shape + (len(moduli), n), dtype=torch.int64)
            return (x + (qcol - 1 if edge == "max" else 0)).to(
                torch.int32).to(dev)
        x = rand_residues(moduli, shape + (len(moduli), n), seed, dev)
        x[..., 0] = 0
        x[..., 1::257] = (qcol - 1).to(torch.int32).to(dev)
        return x

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    x = operand(cols, lead + (2,), 7)
    prod = operand(qs, lead + (3,), 8)
    a, b = operand(qs, lead + (2,), 9), operand(qs, lead + (2,), 10)
    plane = operand(qs, (), 11)
    pt = (operand(qs[:1], (), 12)[0] % 65537).expand(level, -1)
    w = operand(qs, (), 13)[:, :1].contiguous()
    col = operand(qs, (), 14)[:, :1].contiguous()
    words = 2 * batch * level * n        # one [batch, 2, level, n] operand
    lines = 2 * batch * level
    red = BEHZ_IMAD["wide"] + BEHZ_IMAD["reduce64"]
    md_imads = 2 * batch * n * ks_imads("ks_mod_down", R, k=k, Lo=level)
    md_bytes = 4 * 2 * batch * R * n + nbytes(div.words)
    md_shape = dict(rows=2 * batch, Lo=level, k=k)
    relin = kk.Tail("relin", prod)
    calls = {"ks_mod_down_relin": (
        "ks_mod_down_relin", lambda: kk.mod_down(x, div, relin),
        lambda: kk.mod_down_plain(x, div, relin),
        md_bytes + 4 * 2 * words, md_imads, md_shape, None)}
    for g, label in ((3, "ks_mod_down_rotate"),
                     (2 * n - 1, "ks_mod_down_rotate g=2n-1")):
        tail = kk.Tail("rotate", prod[..., 0, :, :], pow(g, -1, 2 * n))
        calls[label] = (
            "ks_mod_down_rotate",
            lambda tail=tail: kk.mod_down(x, div, tail),
            lambda tail=tail: kk.mod_down_plain(x, div, tail),
            md_bytes + 4 * (words // 2 + words), md_imads, md_shape, None)
    calls.update({
        "rns_ew_add": ("rns_ew_add", lambda: ew.add(a, b, q, ratio),
                       lambda: ew.ew_plain("add", a, b, q),
                       4 * 3 * words + nbytes(q), 0, lines, None),
        "rns_ew_sub": ("rns_ew_sub", lambda: ew.sub(a, b, q, ratio),
                       lambda: ew.ew_plain("sub", a, b, q),
                       4 * 3 * words + nbytes(q), 0, lines, None),
        "rns_ew_mul": ("rns_ew_mul", lambda: ew.mul(a, plane, q, ratio),
                       lambda: ew.ew_plain("mul", a, plane, q),
                       4 * (2 * words + level * n) + nbytes(q, ratio),
                       words * red, lines, None),
        "rns_ew_neg": ("rns_ew_neg", lambda: ew.neg(a, q),
                       lambda: ew.ew_plain("neg", a, None, q),
                       4 * 2 * words + nbytes(q), 0, lines, None),
        "rns_ew_mul column": (
            "rns_ew_mul", lambda: ew.mul(a, col, q, ratio),
            lambda: ew.ew_plain("mul", a, col, q),
            4 * 2 * words + nbytes(q, ratio, col), words * red, lines, None),
        "rns_ew_add c0": (
            "rns_ew_add", lambda: ew.add(a, pt, q, ratio, w=w, first=True),
            lambda: ew.ew_plain("add", a, pt, q, w, True),
            4 * (2 * words + n) + nbytes(q, ratio, w), words // 2 * red,
            lines, None),
        "rns_ew_neg c0": (
            "rns_ew_neg", lambda: ew.neg(a, q, ratio, b=pt, w=w),
            lambda: ew.ew_plain("neg", a, pt, q, w, True),
            4 * (2 * words + n) + nbytes(q, ratio, w), words // 2 * red,
            lines, None)})
    return calls


def phase_elementwise(dev):
    """Phase 2e: the K9 kernels (ks_mod_down with the relinearization's and
    the rotation's tails, the RNS elementwise ops) against their plain
    versions at phase 2c's shapes and on edge inputs; times, launches and
    compiler census at K9_TIMED. Returns the kernels line's stats (the main
    path's shape)."""
    from abc_tpu_torch.ops import _build
    from abc_tpu_torch.ops import elementwise_kernels as ew
    from abc_tpu_torch.ops import kernel_census as kc
    from abc_tpu_torch.ops import keyswitch_kernels as kk

    table = kc.kernel_table(_build.build_log, _build.sass(),
                            prefix=K9A + ("rns_ew_",))
    check(len(table) >= 8, f"no ptxas / SASS record of the K9 kernels: "
          f"{sorted(table)}")
    stats = {name: {"max_abs_err": 0} for name in K9A + K9B}
    cases = [(shape, None) for shape in KS_SHAPES] + \
        [(shape, edge) for shape in K9_EDGE_SHAPES
         for edge in ("zero", "max")]
    for shape, edge in cases:
        scheme, n, L, k, batch, level = shape
        at = f"{scheme} n={n} L={L} k={k} ciphertexts={batch} level={level}" \
            + (f" edge {edge}" if edge else "")
        line = []
        for label, (name, kern, plain, n_bytes, imads, lines, library) in \
                k9_calls(*shape, edge, dev).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            check(torch.equal(got, want), f"{label} != plain at {at}")
            if edge is not None or shape not in K9_TIMED:
                continue
            if name in K9A:
                info = kk.mod_down_plan(name, n, **lines)
                key, split = kc.ks_launch_key(name, info), \
                    ks_split(name, info)
            else:
                info = ew.launch_info(name[len("rns_ew_"):], lines, n)
                key = kc.ew_launch_key(name, info)
                split = f", {info['arg0']} quads a thread"
            row = table.get(key, {})
            check(row, f"no ptxas / SASS record of {key}")
            check(row.get("CALL") == 0 and not row.get("spill_stores"),
                  f"{key} calls a subroutine (a 64-bit division) or "
                  f"spills: {kc.fmt_kernel(row)}")
            st = {}
            line.append(
                f"{label} " + _timed(st, kern, plain, list(shape),
                                     bound(n_bytes, imads), library)
                + f" [{key}: {info['threads']} threads x {info['blocks']} "
                f"blocks{split}, {info['blocks_per_sm']} blocks "
                f"({info['warps_per_sm']} warps) an SM; "
                f"{kc.fmt_kernel(row)}]")
            if shape == KS_SHAPES[0] and label == name:
                stats[name].update(st, launch={"kernel": key, **info, **row})
        print(f"  {at}: every K9 kernel = plain"
              + ("" if not line else "; " + "; ".join(line)), flush=True)
    chain_stress(dev)
    return stats


def chain_stress(dev, runs=CHAIN_STRESS_RUNS):
    """Two dependent chains of K9 launches at LaplaceSharpening's shape
    (KS_SHAPES[4]), each reading the output of the launch just before:
    rns_ew_mul -> rns_ew_add -> ks_mod_down_rotate, the add's output (a) the
    mod down's x, the key switch's halves, or (b) the rotation's c0; each
    `runs` times eagerly and `runs` replays of one captured graph, on fresh
    inputs each run (drawn on the card, copied into the graph's static
    inputs), every result equal to the plain chain on the same inputs. A
    kernel that read its operand before the launch before it had written
    it (as a programmatic dependent launch that read before
    griddepcontrol.wait would) shows the run before's words. The graph
    holds exactly the chain's 3 kernels."""
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.ops import elementwise_kernels as ew
    from abc_tpu_torch.ops import keyswitch_kernels as kk
    from abc_tpu_torch.ops.modarith import as_residues, ratio_table
    from abc_tpu_torch.utils.timing import graph_of
    _, n, L, k, _, level = KS_SHAPES[4]
    p = BfvParams.create(n, seed=11, ks_digits=k)
    qs, cols = p.data_primes[:level], p.data_primes[:level] + \
        p.special_primes
    div, ginv = kk.Division(cols, k, dev), pow(3, -1, 2 * n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(CHAIN_STRESS_RUNS)

    def tables(moduli):
        return (as_residues(np.asarray(moduli, np.uint32).reshape(-1, 1),
                            dev), ratio_table(moduli, dev))

    def fresh(moduli, lead):
        q = torch.tensor(moduli, dtype=torch.int64, device=dev)
        x = torch.randint(0, 1 << 62, lead + (len(moduli), n),
                          generator=gen, device=dev)
        return (x % q[:, None]).to(torch.int32)

    tq, tc = tables(qs), tables(cols)
    chains = {
        "x": (cols, lambda a, b, m, c0: kk.mod_down(
            ew.add(ew.mul(a, m, *tc), b, *tc), div,
            kk.Tail("rotate", c0, ginv))),
        "c0": (qs, lambda a, b, m, x: kk.mod_down(
            x, div, kk.Tail("rotate", ew.add(ew.mul(a, m, *tq), b, *tq)[0],
                            ginv))),
    }
    for what, (moduli, chain) in chains.items():
        q_plain = (tc if what == "x" else tq)[0]
        other = qs if what == "x" else cols

        def draw():
            return (fresh(moduli, (2,)), fresh(moduli, (2,)),
                    fresh(moduli, ()),
                    fresh(other, () if what == "x" else (2,)))

        def plain(a, b, m, o):
            s = ew.ew_plain("add", ew.ew_plain("mul", a, m, q_plain), b,
                            q_plain)
            if what == "x":
                return kk.mod_down_plain(s, div, kk.Tail("rotate", o, ginv))
            return kk.mod_down_plain(o, div, kk.Tail("rotate", s[0], ginv))

        for _ in range(runs):
            ins = draw()
            got = chain(*ins)
            check(torch.equal(got, plain(*ins)),
                  f"chain stress, chain {what}, eager: != plain")
        static = draw()
        g = graph_of(lambda ins: chain(*ins), static)
        kernels, _, _ = graph_census(g, {**{nm: 0 for nm in
                                            launch_counts()},
                                         "rns_ew_mul": 1, "rns_ew_add": 1,
                                         "ks_mod_down_rotate": 1},
                                     f"the stress chain {what}")
        check(kernels == 3, f"the stress chain {what} holds {kernels} "
              "kernel nodes, not 3")
        for _ in range(runs):
            ins = draw()
            for dst, src in zip(static, ins):
                dst.copy_(src)
            g.replay()
            check(torch.equal(g.output, plain(*ins)),
                  f"chain stress, chain {what}, replay: != plain")
        del g
    torch.cuda.synchronize()
    print(f"  chain stress (n={n}, L={level}): rns_ew_mul -> rns_ew_add -> "
          f"ks_mod_down_rotate, the add's output as x and as c0, {runs} "
          f"eager runs and {runs} replays of each on fresh inputs: every "
          "result = plain", flush=True)


def phase_mult_relin(dev, k, gold):
    from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.ops import ntt_kernels as nk

    params = BfvParams.create(gold["n"], seed=gold["seed"], ks_digits=k)
    ctx, cpu = BfvContext(params, dev), BfvContext(params, "cpu")
    a, b = ctx.encrypt_many([ctx.encode(gold["a"]), ctx.encode(gold["b"])])
    ca, cb = cpu.encrypt_many([cpu.encode(gold["a"]), cpu.encode(gold["b"])])
    got, want = ctx.multiply(a, b), cpu.multiply(ca, cb)
    relin, cpu_relin = ctx.get_relin_key(), cpu.get_relin_key()
    words = {"pk_b": (ctx.pk_b_ntt, cpu.pk_b_ntt),
             "pk_a": (ctx.pk_a_ntt, cpu.pk_a_ntt),
             "relin_b": (relin[0], cpu_relin[0]),
             "relin_a": (relin[1], cpu_relin[1]),
             "ct_a": (a.data, ca.data), "ct_b": (b.data, cb.data),
             "result": (got.data, want.data)}
    for name, (on_card, on_cpu) in words.items():
        check(torch.equal(on_card.cpu(), on_cpu),
              f"k={k}: {name} on the card != the port's CPU run")
        check(digest(on_card) == gold[name],
              f"k={k}: {name} != golden digest (abc_tpu np64)")
    expect = [x * y for x, y in zip(gold["a"], gold["b"])]
    check(ctx.decode(ctx.decrypt(got))[:len(expect)] == expect,
          f"mult+relin k={k} decrypt")
    before = launch_counts()
    fresh = [BfvCiphertext(a.data.clone()), BfvCiphertext(b.data.clone())]
    ctx.multiply(*fresh)
    torch.cuda.synchronize()
    per_op = since(before)
    check(per_op == MULT_RELIN_CENSUS,
          f"k={k}: launches per mult+relin {per_op}")
    ms = cuda_ms(lambda: ctx.multiply(BfvCiphertext(a.data.clone()),
                                      BfvCiphertext(b.data.clone())), reps=20)
    print(f"  k={k}: keys, ciphertexts and result word-identical to the CPU "
          f"run and the golden digests, decrypts {expect}; launches per op "
          f"{per_op}; {ms:.3f} ms/op (median of 20, fresh operands)",
          flush=True)
    prof = kernel_profile(lambda: ctx.multiply(BfvCiphertext(a.data.clone()),
                                               BfvCiphertext(b.data.clone())))
    print(f"  k={k} device kernels per op: {fmt(prof)}", flush=True)
    kernels, others, replay, replay_prof = op_graph(
        ctx, lambda x: ctx.multiply(BfvCiphertext(x), b).data,
        a.data.clone(), MULT_RELIN_CENSUS)
    print(f"  k={k} as a CUDA graph: {kernels} kernel nodes, exactly the "
          f"hand-written ones {MULT_RELIN_CENSUS} and no other kernel "
          f"(the graph's node list; other nodes {others}); {replay:.4f} ms "
          f"per replay (CUDA events, median of 10), device "
          f"{fmt(replay_prof)} (profiler, records seen)", flush=True)
    chains = chain_profile(lambda: ctx.multiply(
        BfvCiphertext(a.data.clone()), BfvCiphertext(b.data.clone())))
    check_in_ranges(chains, f"k={k}")
    print(f"  k={k} device time per chain (eager profile with host ranges): "
          + fmt_chains(chains, f"{kernels:.0f}"), flush=True)
    if k == 1:
        # where the time of the bench's widest point goes: the same op on a
        # batch, [B, 2, L, n] (the kernel count does not grow with B)
        xs, ys = (torch.stack([t.data] * PHASE3_BATCH) for t in (a, b))
        chains = chain_profile(lambda: ctx.multiply(
            BfvCiphertext(xs.clone()), BfvCiphertext(ys.clone())))
        check_in_ranges(chains, f"k=1, B={PHASE3_BATCH}")
        print(f"  k=1, B={PHASE3_BATCH} device time per chain (eager profile "
              f"with host ranges): " + fmt_chains(chains, f"{kernels:.0f}"),
              flush=True)
    if prof is None:
        return ms, None
    ntt = sum(v for name, v in prof[2].items() if "ntt_" in name)
    top = sorted(prof[2].items(), key=lambda kv: -kv[1])[:6]
    print(f"    NTT kernels {ntt:.4f} ms; busy share of the op "
          f"{prof[0] / ms:.3f}; top: " + "; ".join(
              f"{name[:60]} {v:.4f} ms" for name, v in top), flush=True)
    return ms, prof[0]


def run_dsl(factory, inputs_src, program_src, output_src):
    """Parse, compile and execute under RuntimeVisitor, as run_compiled
    does; returns the output ciphertext and the host-clock times (ms) of
    input encryption and computation."""
    from abc_tpu_torch import (CompileOptions, Parser, compile_program,
                               input_types_from_ast)
    from abc_tpu_torch.runtime.executor import RuntimeVisitor

    inputs = Parser.parse(inputs_src)
    compiled = compile_program(program_src, input_types_from_ast(inputs),
                               CompileOptions())
    t0 = time.perf_counter()
    rv = RuntimeVisitor(factory, inputs, compiled.secret_tainted)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rv.execute_ast(compiled.ast)
    ct = rv.get_output(Parser.parse(output_src))[0][1]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return ct, {"input_encryption": (t1 - t0) * 1e3,
                "computation": (t2 - t1) * 1e3}


def readme_hamming(factory, gold):
    """The README quick start: compile_program (vectorized) -> run_compiled
    with `factory`; returns the output ciphertext."""
    from abc_tpu_torch import (CompileOptions, Parser, compile_program,
                               input_types_from_ast, run_compiled)

    inputs = Parser.parse(gold["inputs"])
    compiled = compile_program(gold["program"], input_types_from_ast(inputs),
                               CompileOptions(vectorize=True))
    _, outputs = run_compiled(compiled, inputs, Parser.parse(gold["output"]),
                              factory)
    return outputs[0][1]


# the main path's second request: ciphertext and plaintext arithmetic that
# the hamming program does not run (a plaintext minus a ciphertext, a
# plaintext product, a ciphertext add, plaintext subtract and add, a
# negation), on the hamming program's inputs
PLAIN_ARITH = ("secret int r = 7 - x; r = r * 3 + y - 2; r = r + 5; "
               "r = 0 - r; return r;")


def plain_arith_oracle(inputs_src):
    import re
    x, y = ([int(v) for v in re.search(name + r" = \{([^}]*)\}",
                                        inputs_src).group(1).split(",")]
            for name in ("x", "y"))
    return [-((7 - a) * 3 + b - 2 + 5) for a, b in zip(x, y)]


def plain_arith(factory, gold):
    """PLAIN_ARITH on the hamming program's inputs through run_compiled
    with `factory`; returns the output ciphertext."""
    from abc_tpu_torch import (CompileOptions, Parser, compile_program,
                               input_types_from_ast, run_compiled)

    inputs = Parser.parse(gold["inputs"])
    compiled = compile_program(PLAIN_ARITH, input_types_from_ast(inputs),
                               CompileOptions())
    _, outputs = run_compiled(compiled, inputs, Parser.parse("out = r;"),
                              factory)
    return outputs[0][1]


def phase_hamming(dev, gold):
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    factory = BfvCiphertextFactory(slots=gold["n"], seed=gold["seed"],
                                   device=dev)
    zero_launches()
    t0 = time.perf_counter()
    ct = readme_hamming(factory, gold)
    torch.cuda.synchronize()
    t_run = (time.perf_counter() - t0) * 1e3
    hd = factory.decrypt(ct)[0]
    arith = plain_arith(factory, gold)
    want = plain_arith_oracle(gold["inputs"])
    got = factory.decrypt(arith)[:len(want)]
    launches = launch_counts()
    cpu_factory = BfvCiphertextFactory(slots=gold["n"], seed=gold["seed"],
                                       device="cpu")
    cpu_ct = readme_hamming(cpu_factory, gold)
    cpu_arith = plain_arith(cpu_factory, gold)
    # the BFV path finishes every key switch in a tail (BFV_ABSENT)
    check_launched(launches, "main path", absent=BFV_ABSENT + MESH_K)
    check(torch.equal(ct.ct.data.cpu(), cpu_ct.ct.data),
          "hamming output on the card != the port's CPU run")
    check(digest(ct.ct.data) == gold["result"],
          "hamming output != golden digest (abc_tpu np64 factory)")
    check(torch.equal(arith.ct.data.cpu(), cpu_arith.ct.data),
          "the arithmetic request's output on the card != the CPU run")
    check(factory.context.counters == cpu_factory.context.counters,
          "hamming op counters differ between card and CPU")
    check(hd == 2, f"hamming decrypts to {hd}")
    check(got == want, f"the arithmetic request decrypts to {got}, not "
          f"{want}")
    print(f"  hamming n={gold['n']}: decrypts to {hd}, word-identical to "
          f"the CPU run and the golden digest; {PLAIN_ARITH!r} decrypts to "
          f"{got} (the plain oracle), word-identical to the CPU run; "
          f"launches of both {launches}; counters "
          f"{factory.context.counters}; hamming's run_compiled {t_run:.1f} "
          f"ms (host clock: encryption, switching-key builds and "
          f"evaluation)", flush=True)
    return launches, ct.ct.data


LAPLACE_SIZE = 4


def laplace_image(seed):
    import random
    rng = random.Random(seed)
    return [rng.randrange(0, 256) for _ in range(LAPLACE_SIZE ** 2)]


def laplace_inputs(img):
    return ("secret int img = {" + ",".join(map(str, img)) + "};"
            f" int imgSize = {LAPLACE_SIZE};")


def laplace_oracle(img):
    size, weights = LAPLACE_SIZE, [1, 1, 1, 1, -8, 1, 1, 1, 1]
    want = list(img)
    for x in range(1, size - 1):
        for y in range(1, size - 1):
            conv = sum(weights[(i + 1) * 3 + j + 1] *
                       img[(x + i) * size + (y + j)]
                       for j in range(-1, 2) for i in range(-1, 2))
            want[x * size + y] = 2 * img[x * size + y] - conv
    return want


def phase_laplace(dev):
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    size = LAPLACE_SIZE
    img = laplace_image(7)
    inputs_src, want = laplace_inputs(img), laplace_oracle(img)

    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factory = BfvCiphertextFactory(slots=LAPLACE_N, seed=LAPLACE_SEED,
                                   device=dev)
    torch.cuda.synchronize()
    t_keygen = (time.perf_counter() - t0) * 1e3
    ct, first = run_dsl(factory, inputs_src, LAPLACE, "out = img2;")
    t0 = time.perf_counter()
    got = factory.decrypt(ct)[:size * size]
    t_dec = (time.perf_counter() - t0) * 1e3
    check(got == want, f"laplace decrypt {got} != oracle {want}")
    c = dict(factory.context.counters)
    check(c["decomp_hit"] > c["decomp"], f"no hoisting: {c}")
    launched = since(before)
    # rotations, ciphertext adds and plaintext products only: no BEHZ
    # kernel and no relinearization, every key-switch kernel of a rotation;
    # keygen, the key build, the encryption and the
    # decryption launch every key kernel (rns_uniform: a fresh context
    # draws inside ksk_compose)
    check(launched["ntt_fwd"] > 0 and launched["ntt_inv"] > 0
          and all(launched[name] for name in ("ks_decompose", "ks_contract",
                                              "ks_mod_down_rotate",
                                              "rns_ew_add", "rns_ew_mul"))
          and not any(launched[name] for name in BEHZ + BFV_ABSENT
                      + ("ks_mod_down_relin",)),
          f"laplace: {launched}")
    check_launched({k: launched[k] for k in RLWE}, "laplace")
    _, steady = run_dsl(factory, inputs_src, LAPLACE, "out = img2;")
    print(f"  laplace n={LAPLACE_N}: decrypts equal to the oracle; counters "
          f"{c}; launches {launched}", flush=True)
    print(f"  phases (host clock, ms): factory+keygen {t_keygen:.1f}, input "
          f"encryption {first['input_encryption']:.1f}, computation "
          f"{first['computation']:.1f} (first run: builds "
          f"{len(factory.context._keys)} switching keys on the card), "
          f"computation again with keys built {steady['computation']:.1f}, "
          f"decryption {t_dec:.1f}", flush=True)
    return factory.context, ct.ct.data, steady["computation"]


def phase_keys(dev, used):
    """A fresh factory of LaplaceSharpening's parameters and seed, then
    every switching key that program used (`used`: phase 5's context), all
    built on the card and timed on the host clock, with the device's share
    of the key build; an encryption and its decryption; and the uniform
    halves regenerated by a context restored without them. The kernel
    launches of this path (counted alone) are the kernels line's for the
    key generation, encryption and decryption kernels."""
    from abc_tpu_torch.crypto.bfv import BfvContext
    from abc_tpu_torch.ops.modarith import to_host
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.scripts.key_profile import device_profile

    ids = sorted(used._keys)

    def context():
        return BfvCiphertextFactory(slots=LAPLACE_N, seed=LAPLACE_SEED,
                                    device=dev).context

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx = context()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    keys = ctx.materialize_keys(ids)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for name, a, b in [("s", ctx.s_ntt_full, used.s_ntt_full),
                       ("pk_b", ctx.pk_b_ntt, used.pk_b_ntt)] + \
            [(kid, keys[kid][0], used._keys[kid][0]) for kid in ids]:
        check(torch.equal(a, b), f"{name}: same seed, another key")
    mb = sum(t.numel() * 4 for pair in keys.values() for t in pair) / 2 ** 20
    fresh = context()
    kern_ms, kernels, copy_ms, copies = device_profile(
        lambda: fresh.materialize_keys(ids), dev)
    build_ms = (t2 - t1) * 1e3
    vals = list(range(1, 17))
    ct = ctx.encrypt(ctx.encode(vals))
    check(ctx.decode(ctx.decrypt(ct))[:16] == vals, "keys: decrypt")
    # (three of the keys: the file's halves come from the host)
    again = BfvContext(ctx.params, dev)
    again.install_keys(None, to_host(ctx.pk_b_ntt), None,
                       {kid: (to_host(keys[kid][0]), None)
                        for kid in ids[:3]}, public_seed=ctx.public_seed)
    check(torch.equal(again.pk_a_ntt, ctx.pk_a_ntt) and
          all(torch.equal(again._keys[kid][1], keys[kid][1])
              for kid in ids[:3]),
          "the regenerated uniform halves differ from the built keys'")
    torch.cuda.synchronize()
    launches = launch_counts()
    check_launched({k: launches[k] for k in RLWE}, "the key path",
                   regenerates=True)
    print(f"  n={LAPLACE_N}: factory+keygen {(t1 - t0) * 1e3:.1f} ms, "
          f"{len(ids)} switching keys ({mb:.0f} MiB) {build_ms:.1f} ms, "
          f"{build_ms / len(ids):.1f} ms per key, all on the card (host "
          f"clock); equal to phase 5's. The key build on the device "
          f"(profiler, a fresh context): {kern_ms:.3f} ms in {kernels} "
          f"kernels and {copy_ms:.3f} ms in {copies} copies, "
          f"{(kern_ms + copy_ms) / build_ms:.1%} of the host clock's "
          f"{build_ms:.1f} ms. An encryption and its decryption equal the "
          f"plaintext; a context restored without the uniform halves "
          f"regenerates them equal; launches on this path {launches}",
          flush=True)
    return launches


def _timed(stats, kern, plain, at, bound_of, library=None):
    """Kernel and plain times (CUDA events and profiler), the kernel's with
    the L2 warm (its calls one after another) and cold (flushed before each
    call), the bound and, where one PyTorch call computes the same words,
    that call's time into stats."""
    # the plain versions are 50-5000 times slower: fewer calls time them
    stats["ms"], stats["plain_ms"] = cuda_ms(kern), cuda_ms(plain, reps=3)
    prof, plain_prof = kernel_profile(kern), kernel_profile(plain, reps=1)
    stats["device_ms"] = prof and prof[0]
    stats["plain_device_ms"] = plain_prof and plain_prof[0]
    stats["cold_ms"] = cuda_ms(kern, cold=True)
    cold = kernel_profile(kern, cold=True)
    stats["cold_device_ms"] = cold and cold[0]
    stats["bound_ms"], stats["bound_by"] = bound_of
    stats["at"] = at
    lib = ""
    if library is not None:
        stats["library_ms"] = cuda_ms(library)
        lib_prof = kernel_profile(library)
        stats["library_device_ms"] = lib_prof and lib_prof[0]
        lib = f"; library {stats['library_ms']:.4f} ms, device {fmt(lib_prof)}"
    under = [what for what, p in (("warm", prof), ("cold", cold))
             if p is not None and p[0] < stats["bound_ms"]]
    why = ("operands L2-resident, not a DRAM reading"
           if stats["bound_by"] == "bytes" else
           "the bound counts more operations than the kernel issues, a "
           "fault of its count")
    return (f"{stats['ms']:.4f} ms (plain {stats['plain_ms']:.4f} ms) "
            f"[device: {fmt(prof)}; cold L2 {stats['cold_ms']:.4f} ms, "
            f"device {fmt(cold)}; plain {fmt(plain_prof)}{lib}; bound "
            f"{stats['bound_ms']:.5f} ms by {stats['bound_by']}"
            + ("" if not under else
               f"; {' and '.join(under)} device time UNDER the bound: "
               f"{why}") + "]")


def phase_ablation(dev):
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.ops import ntt_ablation as na
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.ops.modarith import as_residues
    from abc_tpu_torch.scripts import ntt_ablation as script

    stats = {k: {"max_abs_err": 0} for k in na.launches}

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        check(torch.equal(got, want), what)

    clusters = set()
    for n, L, batch in ABLATION_SHAPES:
        moduli = gen_ntt_primes(30, L, n)
        ctx = NttContext(n, moduli, dev)
        x = rand_residues(moduli, (batch, L, n), seed=n + 2 * L + batch,
                          device=dev)
        clusters.add(nk.cluster_size(L * batch, n))
        fwd = nk.ntt_fwd(x, ctx.q, ctx.fwd_tw, ctx.fwd_tw_sh)
        for mode in na.MODES:
            got = na.ablate_ntt(x, ctx, mode)
            hold("ablate_ntt", got,
                 na.ablate_ntt_plain(x, ctx.q, ctx.fwd_tw, mode),
                 f"ablate_ntt {mode} != plain at {n, L, batch}")
            if mode in na.NTT_MODES:
                hold("ablate_ntt", got, fwd,
                     f"ablate_ntt {mode} != ntt_fwd at {n, L, batch}")
        line = (f"  n={n} L={L} batch={batch} ({L * batch} rows x "
                f"{nk.cluster_size(L * batch, n)} CTAs): {len(na.MODES)} "
                f"modes = plain, the NTT modes = ntt_fwd")
        if (n, L, batch) == ABLATION_SHAPES[0]:
            mode = ABLATION_TIMED["ablate_ntt"]
            line += f"; {mode}: " + _timed(
                stats["ablate_ntt"], lambda: na.ablate_ntt(x, ctx, mode),
                lambda: na.ablate_ntt_plain(x, ctx.q, ctx.fwd_tw, mode),
                [n, L, batch], ntt_bound(n, L, L * batch, False))
        print(line, flush=True)
    check(clusters == {1, 2, 4, 8},
          f"ablation shapes reach cluster sizes {clusters}")

    rng = np.random.default_rng(12)
    xa = as_residues(rng.integers(0, 1 << 32, size=ALU_SHAPE,
                                  dtype=np.uint64), dev)
    for kind in na.ALU_KINDS:
        hold("alu_chain", na.alu_chain(xa, kind, ALU_ITERS),
             na.alu_chain_plain(xa, kind, ALU_ITERS),
             f"alu_chain {kind} != plain")
    kind = ABLATION_TIMED["alu_chain"]
    print(f"  alu_chain {'/'.join(na.ALU_KINDS)} {list(ALU_SHAPE)} x "
          f"{ALU_ITERS} = plain; {kind}: " + _timed(
              stats["alu_chain"], lambda: na.alu_chain(xa, kind, ALU_ITERS),
              lambda: na.alu_chain_plain(xa, kind, ALU_ITERS),
              list(ALU_SHAPE) + [ALU_ITERS],
              # words in and out; 3 multiply-adds per word and iteration
              bound(2 * 4 * xa.numel(), 3 * xa.numel() * ALU_ITERS)),
          flush=True)

    # the path: the ablation script's measurement, counted alone
    for name in na.launches:
        na.launches[name] = 0
    result = script.run(quick=True,
                        log=lambda *a: print("   ", *a, flush=True))
    torch.cuda.synchronize()
    launches = dict(na.launches)
    check(all(v > 0 for v in launches.values()),
          f"the ablation path launched a kernel no time: {launches}")
    chains = result["census"]["alu_chain"]
    check(not any(c["folded"] for c in chains.values()),
          f"ALU chains folded by the compiler: {chains}")
    times = [result[m]["us_per_fwd"] for m in na.MODES + ("shipping",)] + \
        [result[f"alu_{k}"]["us_per_launch"] for k in na.ALU_KINDS]
    check(all(np.isfinite(t) and t > 0 for t in times),
          f"ablation times not positive: {times}")
    # `full` is ntt_fwd_kernel compiled from the same source: the same
    # instructions in its butterfly loop
    same = ("instructions_per_butterfly", "alu_per_butterfly",
            "imad_per_butterfly")
    census = result["census"]
    check(all(census[key] == census["shipping"][key] for key in same),
          "full's SASS census != ntt_fwd's: " + str(
              {key: (census[key], census["shipping"][key]) for key in same}))
    print("  SASS: " + ", ".join(
        f"alu_{k} {c['ops_per_iter']} IMAD / {c['instructions_per_iter']} "
        f"instructions per iteration (not folded)"
        for k, c in chains.items()) + "; per butterfly: " + ", ".join(
            f"{what} {c['instructions_per_butterfly']:.2f} instructions, "
            f"{c['alu_per_butterfly']:.2f} ALU, {c['imad_per_butterfly']:.2f}"
            f" IMAD" for what, c in (("full", census),
                                     ("ntt_fwd", census["shipping"])))
        + f"; full_over_shipping {result['full_over_shipping']:.3f} (graph "
        f"two-point, same process); launches {launches}", flush=True)
    print(json.dumps({"ntt_ablation": result}), flush=True)
    return stats, launches


def replay_ms(jp, tensors, reps):
    """(median ms of one run_raw between CUDA events, "spread max M, iqr Q":
    the largest distance of a run from that median and the interquartile
    range, both relative to the median)."""
    jp.run_raw(tensors)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        jp.run_raw(tensors)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    med = statistics.median(times)
    q1, _, q3 = statistics.quantiles(times, n=4)
    return med, (f"spread max {max(abs(t - med) for t in times) / med:.3f}, "
                 f"iqr {(q3 - q1) / med:.3f}")


def unchanged_across(jp, tensors):
    """run_raw(tensors) with every Python-side counter held still."""
    before = launch_counts(), dict(jp.factory.context.counters), jp._graph
    raw = jp.run_raw(tensors)
    torch.cuda.synchronize()
    check((launch_counts(), dict(jp.factory.context.counters),
           jp._graph) == before,
          "a replay moved a launch or op counter, or made a new graph")
    return raw


def walk_launches(jp):
    """Hand-written kernel launches of one eager walk of the program."""
    before = launch_counts()
    jp.run_eager(jp.secret_inputs)
    return since(before)


def replay_profile(jp, tensors, per_walk, reps=5):
    """kernel_profile of a replay (None where the profiler saw nothing) of
    a program whose graph must hold exactly the hand-written kernels that
    one walk of the program launches (graph_census): they are inside the
    graph, and nothing else took their place."""
    graph_census(jp._graph, per_walk, "a program's graph, whose walk "
                 f"launches the hand-written kernels {per_walk},")
    return kernel_profile(lambda: jp.run_raw(tensors), reps)


def phase_whole_program(dev, gold, hamming_words, laplace_words,
                        laplace_eager_ms, mult_eager):
    from abc_tpu_torch import CompileOptions, jit_compile_program
    from abc_tpu_torch.crypto.bfv import BfvCiphertext
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    # --- the README hamming program as one graph, n=8192
    g = gold["hamming_n8192"]
    factory = BfvCiphertextFactory(slots=g["n"], seed=g["seed"], device=dev)
    zero_launches()
    jp = jit_compile_program(g["program"], g["inputs"], g["output"],
                             factory=factory,
                             options=CompileOptions(vectorize=True))
    raw = jp.run_raw(jp.secret_inputs)
    torch.cuda.synchronize()
    launches = launch_counts()
    out_name = next(iter(raw))
    # hamming: no plaintext product and no negation
    check_launched({k: v for k, v in launches.items()
                    if k != "bfv_dec_round"}, "the whole-program path",
                   absent=BFV_ABSENT + ("rns_ew_mul", "rns_ew_neg")
                   + MESH_K)
    per_walk = walk_launches(jp)
    check(torch.equal(raw[out_name], hamming_words),
          "hamming as a graph != phase 4's eager words")
    check(digest(raw[out_name]) == g["result"],
          "hamming as a graph != golden digest (abc_tpu np64 factory)")
    hd = jp.run()[out_name][0]
    check(hd == 2, f"hamming as a graph decrypts to {hd}")
    prof = replay_profile(jp, jp.secret_inputs, per_walk)
    ms, spread = replay_ms(jp, jp.secret_inputs, 20)
    print(f"  hamming n={g['n']}: run() decrypts to {hd}; raw words equal to "
          f"phase 4's eager run and the golden digest; launches on this "
          f"path {launches} (encryption, key builds, warm-up and capture; "
          f"one walk of the program {per_walk}, and the graph's node list "
          f"holds exactly those); phase_ms "
          f"{ {k: round(v, 1) for k, v in jp.phase_ms.items()} }; "
          f"device bytes {jp.device_bytes}; replay {ms:.3f} ms (CUDA events, "
          f"median of 20, {spread}); device: {fmt(prof)}",
          flush=True)

    # --- serving: fresh inputs through the same graph
    for x, y in (([0, 0, 0, 0], [1, 1, 1, 1]), ([1, 0, 1, 0], [1, 0, 1, 0]),
                 ([1, 1, 1, 0], [0, 1, 0, 0])):
        fresh = jp.encrypt_inputs({"x": x, "y": y})
        raw = unchanged_across(jp, fresh)
        got = jp.decrypt_outputs(raw)[out_name][0]
        want = sum(int(a != b) for a, b in zip(x, y))
        check(got == want, f"serving {x} {y}: {got} != oracle {want}")
        check(torch.equal(raw[out_name], jp.run_eager(fresh)[out_name]),
              f"serving {x} {y}: replay != eager run on the same ciphertexts")
    held = jp.run_raw(jp.secret_inputs)[out_name]
    jp.run_raw(fresh)
    check(torch.equal(held, hamming_words),
          "a later run_raw overwrote an earlier result")
    print("  serving: 3 fresh input pairs, each equal to the oracle and to "
          "an eager run on the same ciphertexts; no launch or op counter "
          "moved across the replays; one graph", flush=True)

    # --- auto_params: the same choice and the same words as the CPU run
    auto = {d: jit_compile_program(
        g["program"], g["inputs"], g["output"], auto_params=True, device=d,
        seed=g["seed"], security_strict=True,
        options=CompileOptions(vectorize=True)) for d in (dev, "cpu")}
    check(auto[dev].auto_params == auto["cpu"].auto_params,
          f"auto_params on the card {auto[dev].auto_params} != on the CPU "
          f"{auto['cpu'].auto_params}")
    raw = auto[dev].run_raw(auto[dev].secret_inputs)[out_name]
    check(torch.equal(
        raw.cpu(), auto["cpu"].run_raw(auto["cpu"].secret_inputs)[out_name]),
        "auto_params: words on the card != the port's CPU run")
    hd = auto[dev].run()[out_name][0]
    check(hd == 2, f"auto_params hamming decrypts to {hd}")
    print(f"  auto_params: {auto[dev].auto_params} on card and CPU alike; "
          f"words equal; decrypts to {hd}", flush=True)
    del auto

    # --- LaplaceSharpening n=16384 as one graph
    factory = BfvCiphertextFactory(slots=LAPLACE_N, seed=LAPLACE_SEED,
                                   device=dev)
    img = laplace_image(7)
    torch.cuda.synchronize()
    allocated0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    jp = jit_compile_program(LAPLACE, laplace_inputs(img), "out = img2;",
                             factory=factory)
    raw = jp.run_raw(jp.secret_inputs)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - allocated0
    check(torch.equal(raw["out"], laplace_words),
          "laplace as a graph != phase 5's eager words")
    img2 = laplace_image(8)
    fresh = jp.encrypt_inputs({"img": img2})
    raw = unchanged_across(jp, fresh)
    got = jp.decrypt_outputs(raw)["out"][:LAPLACE_SIZE ** 2]
    check(got == laplace_oracle(img2),
          f"laplace replay on a fresh image {got} != oracle")
    check(torch.equal(raw["out"], jp.run_eager(fresh)["out"]),
          "laplace replay != eager run on the same ciphertext")
    ms, spread = replay_ms(jp, fresh, 10)
    per_walk = walk_launches(jp)
    prof = replay_profile(jp, fresh, per_walk)
    print(f"  laplace n={LAPLACE_N}: words equal to phase 5's; a fresh image "
          f"equal to the oracle and to an eager run; phase_ms "
          f"{ {k: round(v, 1) for k, v in jp.phase_ms.items()} }; device "
          f"bytes {jp.device_bytes}, peak allocated while building and "
          f"running it {peak} above what phases 5-6 still hold; host "
          f"constants on the tape "
          f"{len(jp._tape.items)}; replay {ms:.3f} ms (CUDA events, median "
          f"of 10, fresh input, {spread}) beside phase 5's "
          f"second eager run {laplace_eager_ms:.1f} ms (host clock); "
          f"device: {fmt_ntt(prof)}, the NTT kernels of one walk "
          f"{per_walk}", flush=True)
    del jp, factory

    # --- mult+relin n=8192 k=1 as one graph: the multiply leaves size 3
    # (lazy relin), the rotation by 0 asks for size 2 and rotates nothing
    g = gold["mult_relin_n8192_k1"]
    factory = BfvCiphertextFactory(slots=g["n"], seed=g["seed"], device=dev)
    jp = jit_compile_program(
        "secret int p = a *** b; p = rotate(p, 0);",
        "secret int a = {%s}; secret int b = {%s};" % (
            ",".join(map(str, g["a"])), ",".join(map(str, g["b"]))),
        "y = p;", factory=factory)
    per_walk = walk_launches(jp)
    check(per_walk == MULT_RELIN_CENSUS,
          f"mult+relin as a program: {per_walk} launches per walk")
    fresh = jp.encrypt_inputs({"a": g["b"], "b": g["a"]})
    raw = unchanged_across(jp, fresh)
    check(torch.equal(raw["y"], factory.context.multiply(
        BfvCiphertext(fresh["a"]), BfvCiphertext(fresh["b"])).data),
        "mult+relin as a graph != BfvContext.multiply on the same operands")
    ms, spread = replay_ms(jp, fresh, 20)
    prof = replay_profile(jp, fresh, per_walk)
    eager_ms, eager_dev = mult_eager
    print(f"  mult+relin n={g['n']} k=1 as a graph: words equal to "
          f"BfvContext.multiply (phase 3's op); {ms:.3f} ms per replay (CUDA events, median of "
          f"20, fresh operands, {spread}; two copies in, one "
          f"clone out) beside phase 3's eager {eager_ms:.3f} ms/op and its "
          f"device-kernel total "
          f"{'not measured' if eager_dev is None else f'{eager_dev:.4f} ms'}"
          f"; replay device: {fmt_ntt(prof)}"
          + f", busy share {busy_share(prof, ms)}"
          + f"; phase_ms { {k: round(v, 1) for k, v in jp.phase_ms.items()} }"
          f"; device bytes {jp.device_bytes}", flush=True)

    # --- the CLI (per-op executor) in a process of its own
    proc = subprocess.run(
        [sys.executable, "-m", "abc_tpu_torch", "hamming", "-", "--backend",
         "bfv", "--slots", str(MAIN_N)], capture_output=True, text=True,
        timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0, f"CLI exit {proc.returncode}: {proc.stderr}")
    check(len(lines) == 2 and lines[0] == "t_keygen,t_input_encryption,"
          "t_computation,t_decryption" and len(lines[1].split(",")) == 4
          and all(float(v) > 0 for v in lines[1].split(",")),
          f"CLI CSV: {proc.stdout!r}")
    check("sum: [2" in proc.stderr, f"CLI stderr: {proc.stderr!r}")
    print(f"  python -m abc_tpu_torch hamming - --backend bfv --slots "
          f"{MAIN_N}: exit 0, {lines[0]} = {lines[1]} (ms, host clock, "
          f"first run of its process), sum: [2 ...", flush=True)
    return launches


# cut from 20 when phases 11-12 came (the script's time budget)
TWO_PROGRAM_ROUNDS = 10


def phase_two_programs(dev, gold):
    """Captured graphs of two contexts alive at once, replayed in turns
    (ROADMAP Queue 3: the graphs of two contexts replayed in turns once
    crashed in cudaGraphLaunch)."""
    from abc_tpu_torch import CompileOptions, jit_compile_program
    from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
    from abc_tpu_torch.scripts import graph_lifetime
    from abc_tpu_torch.utils.timing import graph_of

    # (i) two programs: the README hamming program under BFV at n=8192 and
    # the config-5 CKKS op at n=32768, fresh inputs every round
    g = gold["hamming_n8192"]
    bfv = jit_compile_program(
        g["program"], g["inputs"], g["output"],
        factory=BfvCiphertextFactory(slots=g["n"], seed=g["seed"],
                                     device=dev),
        options=CompileOptions(vectorize=True))
    out_b = next(iter(bfv.run_raw(bfv.secret_inputs)))
    first = bfv.encrypt_inputs({"x": [1, 0, 0, 1], "y": [0, 0, 1, 1]})
    alone = bfv.run_raw(first)[out_b]       # the CKKS program not yet made
    c = gold["ckks_mult_relin_n32768_k2"]
    params = CkksParams.create(c["n"], levels=c["levels"], seed=c["seed"],
                               ks_digits=c["ks_digits"])
    ckks = jit_compile_program(
        "secret double p = a *** a; p = rotate(p, 0);",
        "secret double a = {" + ", ".join(map(repr, c["a"])) + "};",
        "y = p;", factory=CkksCiphertextFactory(
            context=CkksContext(params, dev)))
    rng = np.random.default_rng(c["seed"])
    for r in range(TWO_PROGRAM_ROUNDS):
        x, y = rng.integers(0, 2, size=(2, 4)).tolist()
        vals = rng.uniform(-1.0, 1.0, 8)
        fresh_b = bfv.encrypt_inputs({"x": x, "y": y})
        fresh_c = ckks.encrypt_inputs({"a": vals})
        raw_b = unchanged_across(bfv, fresh_b)[out_b]
        raw_c = unchanged_across(ckks, fresh_c)["y"]
        check(torch.equal(raw_b, bfv.run_eager(fresh_b)[out_b])
              and torch.equal(raw_c, ckks.run_eager(fresh_c)["y"]),
              f"round {r}: a replay != its program's eager run on the same "
              "ciphertexts")
        hd = bfv.decrypt_outputs({out_b: raw_b})[out_b][0]
        check(hd == sum(int(u != v) for u, v in zip(x, y)),
              f"round {r}: hamming {x} {y} decrypts to {hd}")
        z = ckks.decrypt_outputs({"y": raw_c})["y"][:len(vals)]
        check(np.allclose(z, vals ** 2, rtol=1e-2, atol=1e-2),
              f"round {r}: the CKKS op decrypts {z[:4]}")
    check(torch.equal(bfv.run_raw(first)[out_b], alone),
          "hamming after the rounds != hamming before the CKKS program "
          "existed, on the same ciphertexts")
    print(f"  (i) hamming (BFV n={g['n']}) and the config-5 op (CKKS "
          f"n={c['n']}) as two graphs alive together: {TWO_PROGRAM_ROUNDS} "
          f"rounds in turns on fresh inputs, every replay equal to its "
          f"program's eager run and to the oracle, no counter moving; "
          f"hamming's words on its first inputs equal before and after",
          flush=True)
    del bfv, ckks

    # (ii) hybrid_ks_ab's first form: k=1 and k=2 contexts, eager multiply
    # + decrypt, chain graphs of each on an input only the graphs hold
    print("  (ii) " + graph_lifetime.replay_in_turns(
        "held", log=lambda _: None), flush=True)

    # (iii) a graph that needs more shared memory than the eager launch
    # after it: ntt_inv at n=32768 on 48 rows (C = 2, 147 456 B) captured,
    # ntt_inv at n=16384 on 48 rows (C = 2, 73 728 B) eager, the replay
    ctxs = {n: NttContext(n, gen_ntt_primes(30, 8, n), dev)
            for n in (32768, 16384)}
    xs = {n: rand_residues(ctx.moduli, (6, 8, n), seed=n, device=dev)
          for n, ctx in ctxs.items()}
    check([nk.cluster_size(48, n) for n in ctxs] == [2, 2],
          "48 rows at n = 32768, 16384 no longer run at C = 2")
    want = ctxs[32768].inv(xs[32768])
    graph = graph_of(ctxs[32768].inv, xs[32768])
    small = ctxs[16384]
    check(torch.equal(small.inv(xs[16384]), nk.inv_ntt_plain(
        xs[16384], small.q, small.inv_tw, small.n_inv)),
        "ntt_inv at n=16384 != plain")
    graph.output.zero_()
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(graph.output, want),
          "ntt_inv graph at n=32768 after an eager n=16384 launch != eager")
    print("  (iii) ntt_inv captured at n=32768 (48 rows x 2 CTAs, 147456 B "
          "of shared memory), launched eagerly at n=16384 (73728 B), then "
          "replayed: equal to the eager run", flush=True)

    # (iv) the collector held off while a stream captures: a graph that it
    # destroyed inside a capture would invalidate the capture
    print("  (iv) " + graph_lifetime.collected_in_capture(guarded=True),
          flush=True)


def ckks_leveled(ctx, vals):
    """The leveled run on one context: multiply with rescale (level 8 ->
    7), a second multiply at level 7 (k=2: the last digit holds one prime,
    alpha = 4 over 7 limbs) left at its product scale, a rotation and
    hoisted rotations of it (Galois key switches through the same partial
    digit), and its rescale to level 6. Returns the ciphertexts by name."""
    x = ctx.encrypt(ctx.encode(vals))
    m1 = ctx.multiply(x, x)
    m2 = ctx.multiply(m1, x, rescale=False)
    out = {"x": x, "x^2": m1, "x^3": m2, "rot1": ctx.rotate(m2, 1)}
    for steps, ct in zip((2, -3, 0), ctx.hoisted_rotations(m2, [2, -3, 0])):
        out[f"hoisted{steps}"] = ct
    out["x^3 rescaled"] = ctx.rescale(m2)
    return out


def phase_ckks(dev, gold):
    from abc_tpu_torch import jit_compile_program
    from abc_tpu_torch.crypto.ckks import (CkksCiphertext, CkksContext,
                                           CkksParams)
    from abc_tpu_torch.crypto.linalg import matvec_bsgs_ckks
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory

    g = gold["ckks_mult_relin_n32768_k2"]
    n, L, k = g["n"], g["levels"], g["ks_digits"]

    def make_params(**kw):
        return CkksParams.create(n, levels=L, seed=g["seed"], ks_digits=k,
                                 **kw)

    params = make_params()
    ctx, cpu = CkksContext(params, dev), CkksContext(params, "cpu")
    stats = {}

    # --- views: the kernels through leveled views against their plain
    # versions, at the op's launch shapes and at level 3
    for name, level, specials, batch in CKKS_OP_SHAPES + CKKS_LOW_SHAPES:
        view = (ctx._ntt_cols if specials else ctx._ntt_level)[level]
        rows = batch * len(view.moduli)
        x = rand_residues(view.moduli, (batch, len(view.moduli), n),
                          seed=level + rows, device=dev)
        x[..., 0] = 0
        x[..., 1::257] = (view.q - 1).reshape(-1, 1)
        kern, plain = _transforms(nk, view, x)[name]
        check(torch.equal(view.fwd(x) if name == "ntt_fwd" else view.inv(x),
                          plain()),
              f"{name} through the level-{level} view != plain at {rows} "
              f"rows")
        line = (f"  {name} level {level}{' + specials' if specials else ''}"
                f", {rows} rows x {nk.cluster_size(rows, n)} CTAs = plain")
        if (name, level, specials, batch) in CKKS_OP_SHAPES:
            st = {}
            line += ": " + _timed(
                st, kern, plain, [n, len(view.moduli), batch],
                ntt_bound(n, len(view.moduli), rows, name == "ntt_inv"))
            if CKKS_JSON_SHAPE[name] == (level, specials, batch):
                stats[name] = st
        print(line, flush=True)

    # --- the config-5 op, eager; launch counts from here on
    zero_launches()
    a, ca = ctx.encrypt(ctx.encode(g["a"])), cpu.encrypt(cpu.encode(g["a"]))
    got = ctx.multiply(a, a, rescale=False)
    want = cpu.multiply(ca, ca, rescale=False)
    relin, cpu_relin = ctx.get_relin_key(), cpu.get_relin_key()
    for name, (on_card, on_cpu) in {
            "pk_b": (ctx.pk_b_ntt, cpu.pk_b_ntt),
            "pk_a": (ctx.pk_a_ntt, cpu.pk_a_ntt),
            "relin_b": (relin[0], cpu_relin[0]),
            "relin_a": (relin[1], cpu_relin[1]),
            "ct_a": (a.data, ca.data),
            "result": (got.data, want.data)}.items():
        check(torch.equal(on_card.cpu(), on_cpu),
              f"CKKS {name} on the card != the port's CPU run")
        check(digest(on_card) == g[name],
              f"CKKS {name} != golden digest (abc_tpu np64)")
    check((got.level, got.scale, got.size) == (L, params.scale ** 2, 2),
          f"CKKS product at level {got.level}, scale {got.scale}")
    check(np.array_equal(ctx.decode(ctx.decrypt(got)),
                         cpu.decode(cpu.decrypt(want))),
          "CKKS decoded product on the card != the port's CPU run")

    def fresh():
        return CkksCiphertext(a.data.clone(), a.level, a.scale)

    seen, launch = [], nk._launch

    def recording(name, x, args):
        seen.append((name, x.numel() // x.shape[-1]))
        return launch(name, x, args)

    before = launch_counts()
    nk._launch = recording
    try:
        op = fresh()
        ctx.multiply(op, op, rescale=False)
    finally:
        nk._launch = launch
    torch.cuda.synchronize()
    per_op = since(before)
    check(seen == CKKS_CENSUS and per_op == CKKS_OP_CENSUS,
          f"CKKS op launched {seen}, {per_op}")

    def one_op():
        op = fresh()
        return ctx.multiply(op, op, rescale=False)

    op_ms = cuda_ms(one_op, reps=20)
    prof = kernel_profile(one_op)
    print(f"  config-5 op, n={n}, {L}+{k} primes, k={k}: multiply(a, a, "
          f"rescale=False) with pk, relin key, ciphertext and result "
          f"word-identical to the CPU run and the golden digests; launches "
          f"{seen}; {op_ms:.3f} ms/op (CUDA events, median of 20, fresh "
          f"operands); device: {fmt_ntt(prof)}"
          + ("" if prof is None else
             f", busy share {prof[0] / op_ms:.3f}; top: " + "; ".join(
                 f"{name[:60]} {v:.4f} ms" for name, v in sorted(
                     prof[2].items(), key=lambda kv: -kv[1])[:6])),
          flush=True)
    kernels, others, replay, replay_prof = op_graph(
        ctx, lambda x: ctx.multiply(*[CkksCiphertext(x, a.level, a.scale)] * 2,
                                    rescale=False).data, a.data.clone(),
        CKKS_OP_CENSUS)
    print(f"  config-5 op as a CUDA graph: {kernels} kernel nodes, exactly "
          f"the hand-written ones {CKKS_OP_CENSUS} and no other kernel (the "
          f"graph's node list; other nodes {others}); {replay:.4f} ms per "
          f"replay (CUDA events, median of 10), device "
          f"{fmt(replay_prof)} (profiler, records seen)", flush=True)
    chains = chain_profile(one_op)
    check_in_ranges(chains, "config-5 op")
    print("  config-5 op, device time per chain (eager profile with host "
          "ranges): " + fmt_chains(chains, f"{kernels:.0f}"), flush=True)
    del ctx, cpu, a, ca, got, want, relin, cpu_relin

    # --- a leveled run, at a prime-sized scale so that a rescaled product
    # keeps its precision (CkksParams.create's note: at 2^25 one rescale
    # leaves a scale of 2^20)
    lv_params = make_params(scale_bits=29)
    rng = np.random.default_rng(g["seed"])
    vals = rng.uniform(-1.0, 1.0, 64)
    lv_ctx = CkksContext(lv_params, dev)
    lv_card = ckks_leveled(lv_ctx, vals)
    lv_cpu = ckks_leveled(CkksContext(lv_params, "cpu"), vals)
    cube = vals ** 3
    # name: (first slot read, expected values there); a rotation to the
    # right by 3 puts slot 0 at slot 3
    oracle = {"x": (0, vals), "x^2": (0, vals ** 2), "x^3": (0, cube),
              "rot1": (0, cube[1:]), "hoisted2": (0, cube[2:]),
              "hoisted-3": (3, cube), "hoisted0": (0, cube),
              "x^3 rescaled": (0, cube)}
    worst = 0.0
    for name, ct in lv_card.items():
        other = lv_cpu[name]
        check(torch.equal(ct.data.cpu(), other.data)
              and (ct.level, ct.scale) == (other.level, other.scale),
              f"CKKS leveled run: {name} on the card != the CPU run")
        first, want = oracle[name]
        z = np.real(lv_ctx.decode(lv_ctx.decrypt(ct)))[first:first + len(want)]
        worst = max(worst, float(np.max(np.abs(z - want))))
        # the reference tests' tolerance at depth two (tests/test_ckks.py)
        check(np.allclose(z, want, rtol=2e-2, atol=2e-2),
              f"CKKS leveled run: {name} decodes {z[:4]}, oracle {want[:4]}")
    levels = {name: ct.level for name, ct in lv_card.items()}
    check([levels[name] for name in ("x", "x^2", "x^3", "rot1",
                                     "x^3 rescaled")]
          == [L, L - 1, L - 1, L - 1, L - 2],
          f"CKKS leveled run: levels {levels}")
    c = dict(lv_ctx.counters)
    check((c["mult"], c["relin"], c["galois"], c["decomp"], c["decomp_hit"])
          == (2, 2, 3, 1, 1), f"CKKS leveled run: counters {c}")
    print(f"  leveled run (scale 2^29): x^2 rescaled to level {L - 1}; x^3 "
          f"there through the partial-digit key switch ({L - 1} limbs, "
          f"alpha = {lv_ctx._alpha_at(L - 1)}), one rotation and 3 hoisted "
          f"rotations of it, its rescale to level {L - 2}: words equal to "
          f"the CPU run; decoded within 2e-2 of numpy (largest error "
          f"{worst:.2e}); counters {c}", flush=True)
    del lv_ctx, lv_card, lv_cpu

    # --- as a graph: the op itself, then multiply + rotate
    def factory_on(device):
        return CkksCiphertextFactory(context=CkksContext(params, device))

    def brace(values):
        return "{" + ", ".join(repr(float(v)) for v in values) + "}"

    factory = factory_on(dev)
    fctx = factory.context
    jp = jit_compile_program("secret double p = a *** a; p = rotate(p, 0);",
                             f"secret double a = {brace(g['a'])};", "y = p;",
                             factory=factory)
    per_walk = walk_launches(jp)
    check(per_walk == CKKS_OP_CENSUS,
          f"CKKS op as a program: {per_walk} launches per walk")
    fresh_in = jp.encrypt_inputs({"a": vals})
    raw = unchanged_across(jp, fresh_in)
    op = CkksCiphertext(fresh_in["a"], L, params.scale)
    check(torch.equal(raw["y"], fctx.multiply(op, op, rescale=False).data),
          "CKKS op as a graph != CkksContext.multiply on the same operand")
    z = jp.decrypt_outputs(raw)["y"][:len(vals)]
    check(np.allclose(z, vals ** 2, rtol=1e-2, atol=1e-2),
          f"CKKS op as a graph decrypts {z[:4]}")
    ms, spread = replay_ms(jp, fresh_in, 20)
    prof = replay_profile(jp, fresh_in, per_walk)
    print(f"  config-5 op as a graph: words equal to CkksContext.multiply; "
          f"{ms:.3f} ms per replay (CUDA events, median of 20, fresh "
          f"operand, {spread}; one copy in, one clone out) beside the eager "
          f"{op_ms:.3f} ms/op; replay device: {fmt_ntt(prof)}, busy share "
          f"{busy_share(prof, ms)}; phase_ms "
          f"{ {k_: round(v, 1) for k_, v in jp.phase_ms.items()} }; device "
          f"bytes {jp.device_bytes}", flush=True)

    a_vals, b_vals = [1.5, 2.0, -0.5, 0.25], [0.5, 0.25, 4.0, -2.0]
    program = dict(program_src="secret double p = a *** b; p = rotate(p, 1);",
                   inputs_src=f"secret double a = {brace(a_vals)}; "
                              f"secret double b = {brace(b_vals)};",
                   output_src="y = p;")
    jp = jit_compile_program(factory=factory, **program)
    jp_cpu = jit_compile_program(factory=factory_on("cpu"), **program)
    raw = jp.run_raw(jp.secret_inputs)
    eager = fctx.rotate(fctx.relinearize(fctx.multiply(
        CkksCiphertext(jp.secret_inputs["a"], L, params.scale),
        CkksCiphertext(jp.secret_inputs["b"], L, params.scale),
        relinearize=False, rescale=False)), 1)
    check(torch.equal(raw["y"], eager.data)
          and torch.equal(raw["y"], jp.run_eager(jp.secret_inputs)["y"]),
          "CKKS program as a graph != the eager run")
    want = [x * y for x, y in zip(a_vals, b_vals)][1:]
    z = jp.run()["y"][:3]
    check(np.allclose(z, want, atol=1e-2), f"CKKS program decrypts {z}")
    per_walk = walk_launches(jp)
    fresh_in = jp.encrypt_inputs({"a": vals, "b": vals[::-1]})
    raw = unchanged_across(jp, fresh_in)
    check(torch.equal(raw["y"], jp.run_eager(fresh_in)["y"]),
          "CKKS program: replay != eager run on the same ciphertexts")
    z = jp.decrypt_outputs(raw)["y"][:len(vals) - 1]
    check(np.allclose(z, (vals * vals[::-1])[1:], atol=1e-2),
          f"CKKS program on fresh inputs decrypts {z[:4]}")
    # the CPU program on the card's own input ciphertexts: the same words
    cpu_raw = jp_cpu.run_raw({name: t.cpu() for name, t in fresh_in.items()})
    check(torch.equal(raw["y"].cpu(), cpu_raw["y"]),
          "CKKS program: words on the card != the port's CPU run")
    ms, spread = replay_ms(jp, fresh_in, 20)
    prof = replay_profile(jp, fresh_in, per_walk)
    print(f"  `{program['program_src']}` as a graph: words equal to the "
          f"eager run and to the CPU run on the same ciphertexts; fresh "
          f"inputs decrypt within 1e-2 of numpy; no launch or op counter "
          f"moved across the replay; one walk launches {per_walk}; "
          f"{ms:.3f} ms per replay (CUDA events, median of 20, {spread}); "
          f"device: {fmt_ntt(prof)}, busy share {busy_share(prof, ms)}; "
          f"phase_ms { {k_: round(v, 1) for k_, v in jp.phase_ms.items()} }"
          f"; device bytes {jp.device_bytes}", flush=True)
    del jp, jp_cpu, factory, fctx

    # --- one float program under auto_params
    inputs = "secret double w0 = {1.0,2.0}; secret double w1 = {0.5,0.25};"
    auto = {d: jit_compile_program(CKKS_DEPTH2, inputs, "out = acc;",
                                   auto_params=True, device=d, seed=5)
            for d in (dev, "cpu")}
    check(auto[dev].auto_params == auto["cpu"].auto_params
          and auto[dev].auto_params["scheme"] == "ckks",
          f"auto_params on the card {auto[dev].auto_params} != on the CPU "
          f"{auto['cpu'].auto_params}")
    check(auto[dev]._graph is not None, "auto_params: no graph on the card")
    raw = auto[dev].run_raw(auto[dev].secret_inputs)["out"]
    check(torch.equal(
        raw.cpu(), auto["cpu"].run_raw(auto["cpu"].secret_inputs)["out"]),
        "CKKS auto_params: words on the card != the port's CPU run")
    z = auto[dev].run()["out"][:2]
    want = [(1.0 * 0.5 + 2.0) * 0.5, (2.0 * 0.25 + 2.0) * 0.25]
    check(np.allclose(z, want, atol=1e-2), f"CKKS auto_params decrypts {z}")
    print(f"  auto_params (float program, depth 2 with a rotation): "
          f"{auto[dev].auto_params} on card and CPU alike; words equal; "
          f"decrypts {[round(v, 4) for v in z]}", flush=True)
    del auto

    # --- the packed matvec: 1024 x 1024 over the slots of n=2048, at a
    # prime-sized scale (the baby rotations come before the multiplies)
    mv = CkksContext(CkksParams.create(CKKS_MATVEC_N, levels=3, seed=3,
                                       scale_bits=29), dev)
    size = mv.params.slot_count
    mat, vec = rng.uniform(-1, 1, (size, size)), rng.uniform(-1, 1, size)
    ct = mv.encrypt(mv.encode(vec))
    for name in mv.counters:
        mv.counters[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = matvec_bsgs_ckks(mv, ct, mat)
    torch.cuda.synchronize()
    t_mv = time.perf_counter() - t0
    err = float(np.max(np.abs(np.real(mv.decode(mv.decrypt(y))) - mat @ vec)))
    check(err < 1e-2, f"matvec_bsgs_ckks: largest error {err}")
    baby = int(size ** 0.5)
    giant = -(-size // baby)
    c = dict(mv.counters)
    # one hoisted decomposition serves all baby steps; each giant step but
    # the first rotates its own partial sum
    check((c["decomp"], c["decomp_hit"], c["galois"])
          == (1 + giant - 1, 0, baby - 1 + giant - 1),
          f"matvec_bsgs_ckks: counters {c}")
    print(f"  matvec_bsgs_ckks n={CKKS_MATVEC_N} ({size} x {size}, scale "
          f"2^29): largest error {err:.2e} against numpy; counters {c} "
          f"({baby} baby steps on one decomposition, {giant} giant steps); "
          f"{t_mv:.1f} s on the host clock", flush=True)
    launches = launch_counts()
    # multiplies, rescales, rotations, adds and the matvec's plaintext
    # products
    check(all(launches[name] > 0 for name in ("ntt_fwd", "ntt_inv",
                                               "behz_tensor") + KS + K9A
              + ("rns_ew_add", "rns_ew_mul")),
          f"the CKKS path launched a kernel no time: {launches}")
    return stats, launches


BENCH_BATCH = 8


def phase_bench(dev, gold):
    """The batch contract on the card, then the measurement entry point in
    process. Returns (NTT kernel launches, ablation kernel launches) of the
    bench run alone."""
    import contextlib
    import io

    from abc_tpu_torch import bench
    from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
    from abc_tpu_torch.crypto.params import BfvParams
    from abc_tpu_torch.ops import ntt_ablation as na

    # --- B ciphertexts through one call against B calls; row 0 holds the
    # golden operands
    g = gold["mult_relin_n8192_k1"]
    ctx = BfvContext(BfvParams.create(g["n"], seed=g["seed"]), dev)
    ctx.ensure_eval_ready()
    ctx.materialize_keys(["relin", f"galois_{pow(3, 3, 2 * g['n'])}"])
    rng = np.random.default_rng(g["seed"])
    extra = rng.integers(-99, 100, size=(2 * BENCH_BATCH - 2, 6)).tolist()
    cts = ctx.encrypt_many([ctx.encode(v) for v in [g["a"], g["b"]] + extra])
    xs = torch.stack([ct.data for ct in cts[0::2]])
    ys = torch.stack([ct.data for ct in cts[1::2]])
    ops = {"multiply": lambda x, y: ctx.multiply(BfvCiphertext(x),
                                                 BfvCiphertext(y)),
           "rotate_rows": lambda x, y: ctx.rotate_rows(BfvCiphertext(x), 3)}
    census = {"multiply": MULT_RELIN_CENSUS, "rotate_rows": ROTATE_CENSUS}
    for name, op in ops.items():
        before = launch_counts()
        with ctx.fresh_caches():
            got = op(xs, ys).data
        made = since(before)
        check(got.shape == xs.shape, f"batched {name}: shape {got.shape}")
        for i in range(BENCH_BATCH):
            with ctx.fresh_caches():
                want = op(xs[i], ys[i]).data
            check(torch.equal(got[i], want),
                  f"batched {name}: row {i} != a separate call")
        if name == "multiply":
            check(digest(got[0]) == g["result"],
                  "batched multiply: row 0 != golden digest (abc_tpu np64)")
        check(made == census[name], f"batched {name} launched {made}")
        print(f"  {name} on [{BENCH_BATCH}, 2, {ctx.params.L}, {g['n']}]: "
              f"every row equal to a separate call"
              + (", row 0 equal to the golden digest"
                 if name == "multiply" else "")
              + f"; launches of the batched call {made}", flush=True)
    del ctx, cts, xs, ys

    # --- python -m abc_tpu_torch.bench --quick, in process
    zero_launches()
    for name in na.launches:
        na.launches[name] = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--quick"])
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = launch_counts(), dict(na.launches)
    lines = out.getvalue().strip().splitlines()
    check(len(lines) >= 2, f"bench printed {len(lines)} lines")
    full, line = json.loads(lines[-2]), json.loads(lines[-1])
    suite = full["suite"]
    check(rc == 0 and not full["problems"],
          f"bench exit {rc}: {full['problems']}")
    check(sorted(suite) == [f"config{i}" for i in range(1, 7)]
          and not any("error" in rec for rec in suite.values()),
          f"bench suite: { {k: v.get('error') for k, v in suite.items()} }")
    check(suite["config3"]["correct"] is True, "config 3: slot 0 != 2")
    check(suite["config4"]["measured"]["decrypt_equal"] is True,
          "config 4: the rewritten circuit decrypts differently")
    check(suite["config6"]["correct"] is True, "config 6: oracle")
    check(all(suite[f"config{i}"]["correct"] is True for i in (1, 2, 5)),
          "config 1, 2 or 5 incorrect")
    check(not full["nan_headlines"],
          f"bench headline values that are nan: {full['nan_headlines']}")
    check(len(lines[-1]) < 1500 and line["ok"] is True,
          f"bench compact line: {len(lines[-1])} characters")
    check(full["device"]["kind"] == torch.cuda.get_device_name(0)
          and full["timer"] == "cuda_graph", f"bench ran on {full['device']}")
    check(sorted(full["mult_relin"]["batch_curve"]) == ["1", "16", "64", "8"]
          and all(row["ntt_launches_per_step"] == [5, 3]
                  for row in full["mult_relin"]["batch_curve"].values()),
          "mult+relin curve: batches or the per-step census")
    # no program of the six configs negates a ciphertext or rescales, and
    # its one mesh op (config 5's sharded word check) runs no psum and ends
    # its key switch in the relinearization's tail
    check_launched(launches[0], "the bench",
                   absent=("rns_ew_neg", "ks_mod_down", "rns_psum_mod"))
    sol = full["mult_relin"]["speed_of_light"]
    print(f"  bench --quick: {seconds:.1f} s, exit 0, six configs without "
          f"error, config 3 correct, config 4 decrypt_equal, config 6 equal "
          f"to the oracle, no nan; launches {launches[0]}; mult+relin "
          f"floor {sol['floor_us']:.3f} us by {sol['bound_by']} "
          f"({sol['ntt_rows']} NTT rows), op at "
          f"{sol['pct_of_floor']:.3f}% of it at B=1", flush=True)
    print(lines[-2], flush=True)
    print(lines[-1], flush=True)
    return launches


# ------------------------------------------------- phase 11: checkpoint serving

SERVE_PAIRS = (([1, 0, 1, 1], [0, 0, 1, 1]), ([1, 1, 1, 1], [0, 0, 0, 0]))
SERVE_REPS = 20
CKKS_SERVE_PROGRAM = "secret double p = a *** a; p = rotate(p, 0);"


def serving_inputs(compiled):
    """The input declarations a server makes for a circuit from its input
    types alone: one placeholder value per secret input (the constructor
    encrypts it under the public key; run_raw then takes the client's
    ciphertexts). A plain input's value belongs to the client's program,
    which the files do not carry: such a circuit is refused."""
    from abc_tpu_torch import Parser
    decls = []
    for name, dt in compiled.input_types.items():
        check(dt.secret, f"plain input {name!r}: a server cannot serve it "
              "from the files alone")
        zero = "0.0" if str(dt.type) in ("float", "double") else "0"
        decls.append(f"{dt} {name} = {{{zero}}};")
    return Parser.parse(" ".join(decls))


def serve(directory, device="cuda"):
    """The server: reads only the files of `directory` (manifest.json, a
    circuit, a public context, the request ciphertexts), serves every
    request through one JittedProgram per scheme, and writes the output
    ciphertexts and serve.json (load time, ms per replay, kernel launches,
    op counters) back. Nothing here can decrypt: the context holds no
    secret."""
    from abc_tpu_torch import Parser
    from abc_tpu_torch.crypto.bfv import BfvCiphertext
    from abc_tpu_torch.crypto.ckks import CkksCiphertext
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
    from abc_tpu_torch.runtime.jit_executor import JittedProgram
    from abc_tpu_torch.utils import checkpoint as ckpt

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def path(name):
        return os.path.join(directory, name)

    with open(path("manifest.json")) as f:
        manifest = json.load(f)
    report = {}
    for scheme, job in manifest.items():
        zero_launches()
        sync()
        t0 = time.perf_counter()
        compiled = ckpt.load_circuit(path(job["circuit"]))
        if scheme == "bfv":
            ctx = ckpt.load_context(path(job["context"]), device=dev)
            factory = BfvCiphertextFactory(context=ctx)
        else:
            ctx = ckpt.load_ckks_context(path(job["context"]), device=dev)
            factory = CkksCiphertextFactory(context=ctx)
        sync()
        load_ms = (time.perf_counter() - t0) * 1e3
        check(ctx.s_ntt_full is None, "the server's context holds a secret")
        keys = sorted(ctx._keys)
        jp = JittedProgram(compiled, factory, serving_inputs(compiled),
                           Parser.parse(job["output"]))
        check(sorted(ctx._keys) == keys,
              f"the server built keys {sorted(set(ctx._keys) - set(keys))}")
        requests = []
        for i, request in enumerate(job["requests"]):
            tensors = {}
            for name, fname in request.items():
                if scheme == "bfv":
                    tensors[name] = ckpt.load_ciphertext(path(fname),
                                                         device=dev).data
                    continue
                ct = ckpt.load_ckks_ciphertext(path(fname), device=dev)
                check((ct.level, ct.scale) == jp._input_meta[name],
                      f"request {i} {name}: (level, scale) "
                      f"{(ct.level, ct.scale)}, the program takes "
                      f"{jp._input_meta[name]}")
                tensors[name] = ct.data
            raw = jp.run_raw(tensors)
            for name, tensor in raw.items():
                out = f"{scheme}_out{i}_{name}" + \
                    (".npy" if scheme == "bfv" else ".npz")
                if scheme == "bfv":
                    ckpt.save_ciphertext(BfvCiphertext(tensor), path(out))
                else:
                    ckpt.save_ckks_ciphertext(CkksCiphertext(
                        tensor, *jp._out_meta[name]), path(out))
                requests.append(out)
        sync()
        launches = launch_counts()
        rec = {"load_ms": load_ms, "phase_ms": jp.phase_ms,
               "launches": launches, "counters": dict(ctx.counters),
               "keys": keys, "outputs": requests}
        if on_card:
            rec["replay_ms"], rec["spread"] = replay_ms(jp, tensors,
                                                        SERVE_REPS)
            check(launch_counts() == launches,
                  "a replay on the server launched a kernel")
        report[scheme] = rec
    with open(path("serve.json"), "w") as f:
        json.dump(report, f)
    return report


def client_files(directory, dev, gold, size_check=True):
    """The client: a seeded context of its own on `dev`, the program
    compiled and captured there (which builds the keys it needs), then the
    circuit, the public context (seeded, without the secret) and two
    requests written into `directory` with a manifest. Returns {scheme:
    (JittedProgram, [request tensors])}."""
    from abc_tpu_torch import CompileOptions, jit_compile_program
    from abc_tpu_torch.crypto.bfv import BfvCiphertext
    from abc_tpu_torch.crypto.ckks import (CkksCiphertext, CkksContext,
                                           CkksParams)
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory
    from abc_tpu_torch.runtime.ckks_backend import CkksCiphertextFactory
    from abc_tpu_torch.utils import checkpoint as ckpt

    g, c = gold["hamming_n8192"], gold["ckks_mult_relin_n32768_k2"]
    outputs = {"bfv": g["output"], "ckks": "y = p;"}
    programs = {
        "bfv": jit_compile_program(
            g["program"], g["inputs"], g["output"],
            factory=BfvCiphertextFactory(slots=g["n"], seed=g["seed"],
                                         device=dev),
            options=CompileOptions(vectorize=True)),
        "ckks": jit_compile_program(
            CKKS_SERVE_PROGRAM, "secret double a = {" + ", ".join(
                map(repr, c["a"])) + "};", outputs["ckks"],
            factory=CkksCiphertextFactory(context=CkksContext(
                CkksParams.create(c["n"], levels=c["levels"], seed=c["seed"],
                                  ks_digits=c["ks_digits"]), dev)))}
    rng = np.random.default_rng(c["seed"])
    ckks_requests = [{"a": rng.uniform(-1.0, 1.0, 16)} for _ in SERVE_PAIRS]
    requests = {"bfv": [{"x": x, "y": y} for x, y in SERVE_PAIRS],
                "ckks": ckks_requests}
    manifest, out, sizes = {}, {}, {}
    for scheme, jp in programs.items():
        ctx = jp.factory.context
        save = ckpt.save_context if scheme == "bfv" else \
            ckpt.save_ckks_context
        ckpt.save_circuit(jp.compiled,
                          os.path.join(directory, f"{scheme}_circuit.json"))
        for kind, seeded in (("seeded", True), ("full", False)):
            save(ctx, os.path.join(directory, f"{scheme}_{kind}.npz"),
                 include_secret_key=False, seeded=seeded)
        sizes[scheme] = {kind: os.path.getsize(os.path.join(
            directory, f"{scheme}_{kind}.npz")) for kind in ("seeded", "full")}
        if size_check:
            check(sizes[scheme]["seeded"] < 0.65 * sizes[scheme]["full"],
                  f"{scheme}: seeded file {sizes[scheme]} not under 0.65 of "
                  "the full one")
        files, tensors = [], []
        for i, values in enumerate(requests[scheme]):
            t = jp.encrypt_inputs(values)
            entry = {}
            for name, tensor in t.items():
                entry[name] = f"{scheme}_in{i}_{name}" + \
                    (".npy" if scheme == "bfv" else ".npz")
                target = os.path.join(directory, entry[name])
                if scheme == "bfv":
                    ckpt.save_ciphertext(BfvCiphertext(tensor), target)
                else:
                    ckpt.save_ckks_ciphertext(CkksCiphertext(
                        tensor, *jp._input_meta[name]), target)
            files.append(entry)
            tensors.append(t)
        manifest[scheme] = {"circuit": f"{scheme}_circuit.json",
                            "context": f"{scheme}_seeded.npz",
                            "output": outputs[scheme], "requests": files}
        out[scheme] = (jp, tensors, requests[scheme])
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return out, sizes


def check_served(directory, client, report, device):
    """The client again: every output file decrypts to the plain oracle and
    holds the words of the same program run in the client's process on the
    same ciphertexts, without files; the CKKS outputs also the words of
    CkksContext.multiply on the request operand (phase 9's op)."""
    from abc_tpu_torch.crypto.ckks import CkksCiphertext
    from abc_tpu_torch.utils import checkpoint as ckpt

    for scheme, (jp, tensors, requests) in client.items():
        outputs = report[scheme]["outputs"]
        check(len(outputs) == len(tensors),
              f"{scheme}: {len(outputs)} outputs for {len(tensors)} requests")
        for i, (fname, t, values) in enumerate(zip(outputs, tensors,
                                                   requests)):
            target = os.path.join(directory, fname)
            raw = jp.run_raw(t)
            name = next(iter(raw))
            here = raw[name]
            if scheme == "bfv":
                served = ckpt.load_ciphertext(target, device=device).data
                got = jp.decrypt_outputs({name: served})[name][0]
                want = sum(int(a != b) for a, b in zip(values["x"],
                                                       values["y"]))
                check(got == want, f"served hamming {values}: {got} != {want}")
            else:
                ct = ckpt.load_ckks_ciphertext(target, device=device)
                check((ct.level, ct.scale) == jp._out_meta[name],
                      f"served CKKS output at {(ct.level, ct.scale)}")
                served = ct.data
                ctx = jp.factory.context
                op = CkksCiphertext(t["a"], *jp._input_meta["a"])
                check(torch.equal(served, ctx.multiply(op, op,
                                                       rescale=False).data),
                      f"served CKKS request {i} != CkksContext.multiply")
                z = jp.decrypt_outputs({name: served})[name][:16]
                check(np.allclose(z, values["a"] ** 2, rtol=1e-2, atol=1e-2),
                      f"served CKKS request {i} decrypts {z[:4]}")
            check(torch.equal(served, here),
                  f"served {scheme} request {i} != the client's own run on "
                  "the same ciphertexts")


def fixture_on(dev, gold):
    """abc_tpu's checkpoint file (testdata) loaded on `dev`: the restored
    keys equal the stored digests, the stored ciphertext decrypts to the
    stored plaintext, and one multiply + relin of it equals the golden
    product."""
    import abc_tpu_torch
    from abc_tpu_torch.utils import checkpoint as ckpt
    g = gold["checkpoint_bfv_n1024"]
    here = os.path.join(os.path.dirname(abc_tpu_torch.__file__), "testdata")
    ctx = ckpt.load_context(os.path.join(here, g["context"]), device=dev)
    ct = ckpt.load_ciphertext(os.path.join(here, g["ciphertext"]), device=dev)
    relin, gal = ctx.get_relin_key(), ctx.get_galois_key(g["galois"])
    got = {"s_coeffs": hashlib.sha256(np.ascontiguousarray(
        np.asarray(ctx.s_coeffs).astype(np.uint32), dtype="<u4").tobytes()
    ).hexdigest(), "pk_b": digest(ctx.pk_b_ntt), "pk_a": digest(ctx.pk_a_ntt),
        "relin_b": digest(relin[0]), "relin_a": digest(relin[1]),
        f"galois_{g['galois']}_b": digest(gal[0]),
        f"galois_{g['galois']}_a": digest(gal[1]), "ct": digest(ct.data)}
    check(got == {k: g[k] for k in got},
          f"abc_tpu's checkpoint restored to other words: "
          f"{[k for k in got if got[k] != g[k]]}")
    plain = ctx.decode(ctx.decrypt(ct))[:len(g["values"])]
    check(plain == g["values"], f"fixture decrypts to {plain}")
    prod = ctx.multiply(ct, ct)
    check(digest(prod.data) == g["product"],
          "fixture: multiply + relin != the golden product")
    check(ctx.decode(ctx.decrypt(prod))[:len(g["values"])]
          == g["product_plain"], "fixture: the product decrypts wrong")


def phase_checkpoint(dev, gold):
    """Checkpoint / resume as a serving path: the client here, the server a
    child process (`python chip_smoke.py --serve DIR`) that reads only the
    client's files; then abc_tpu's own checkpoint file on the card. Returns
    the server's kernel launches (both schemes)."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="abc_serve_") as directory:
        t0 = time.perf_counter()
        client, sizes = client_files(directory, dev, gold)
        t_client = time.perf_counter() - t0
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--serve", directory],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0,
              f"the server exited {proc.returncode}:\n{proc.stdout[-3000:]}"
              f"\n{proc.stderr[-3000:]}")
        with open(os.path.join(directory, "serve.json")) as f:
            report = json.load(f)
        check_served(directory, client, report, dev)
    launches = {}
    for scheme, rec in report.items():
        # hamming multiplies ciphertexts (every BEHZ kernel), the CKKS op
        # takes the tensor product alone; both relinearize
        need = ("ntt_fwd", "ntt_inv", "ks_decompose", "ks_contract",
                "ks_mod_down_relin") + (
            BEHZ if scheme == "bfv" else ("behz_tensor",)) + (
            # the server's fresh context (keygen) and the uniform halves
            # its file left out, regenerated on the card
            "rns_uniform", "ksk_compose", "rlwe_lift")
        check(all(rec["launches"].get(k, 0) > 0 for k in need),
              f"the server's {scheme} path launched {rec['launches']}")
        for k, v in rec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        s = sizes[scheme]
        print(f"  {scheme}: public context {s['seeded']} B seeded against "
              f"{s['full']} B full ({s['seeded'] / s['full']:.3f}); server "
              f"load {rec['load_ms']:.1f} ms (circuit + context, keys "
              f"{rec['keys']}, host clock); {rec['replay_ms']:.3f} ms per "
              f"replay (CUDA events, median of {SERVE_REPS}, "
              f"{rec['spread']}); server phase_ms "
              f"{ {k: round(v, 1) for k, v in rec['phase_ms'].items()} }; "
              f"server launches {rec['launches']}; every output decrypts "
              f"to the oracle and equals the client's own run", flush=True)
    print(f"  client: contexts, keys, capture and files {t_client:.1f} s "
          f"(host clock); the server, a child process reading only the "
          f"files, held no secret and built no key", flush=True)
    fixture_on(dev, gold)
    print("  abc_tpu's checkpoint (testdata, n=1024, seeded): keys equal "
          "to the stored digests, decrypts to the stored plaintext, its "
          "multiply + relin equal to the golden product", flush=True)
    return launches


# ------------------------------------------ phase 12: reference-scale workloads

def _brace(values):
    return "{" + ",".join(map(str, values)) + "}"


def _image(seed, size, high):
    import random
    rng = random.Random(seed)
    return [rng.randrange(0, high) for _ in range(size * size)]


def _stencil_program(array, weights):
    return f"""
      int {array} = {_brace(weights)};
      secret int img2 = img;
      for (int x = 1; x < imgSize-1; x = x + 1) {{
        for (int y = 1; y < imgSize-1; y = y + 1) {{
          secret int value = 0;
          for (int j = -1; j < 2; j = j + 1) {{
            for (int i = -1; i < 2; i = i + 1) {{
              value = value + {array}[(i + 1)*3 + j + 1]
                  *img[((x + i)*imgSize + (y + j))];
            }}
          }}
          img2[imgSize*x + y] = value;
        }}
      }}
      return img2;
    """


def _stencil(seed, high, array, weights):
    size = 8
    img = _image(seed, size, high)
    want = list(img)
    for x in range(1, size - 1):
        for y in range(1, size - 1):
            want[x * size + y] = sum(
                weights[(i + 1) * 3 + (j + 1)] * img[(x + i) * size + (y + j)]
                for j in range(-1, 2) for i in range(-1, 2))
    return dict(n=8192, inputs=f"secret int img = {_brace(img)}; int "
                f"imgSize = {size};", program=_stencil_program(array, weights),
                output="out = img2;", vectorize=False, want={"out": want})


def _reduction(name, seed, lo, hi, term, out):
    import random
    rng = random.Random(seed)
    xs = [rng.randrange(lo, hi) for _ in range(16)]
    ys = [rng.randrange(lo, hi) for _ in range(16)]
    program = f"""
      int sum = 0;
      for (int i = 0; i < 16; i = i + 1) {{
        sum = sum + {term};
      }}
      return sum;
    """
    value = {"hamming": sum(int(a != b) for a, b in zip(xs, ys)),
             "l2": sum((a - b) ** 2 for a, b in zip(xs, ys)),
             "dot": sum(a * b for a, b in zip(xs, ys))}[name]
    return dict(n=8192, inputs=f"secret int x = {_brace(xs)}; secret int y "
                f"= {_brace(ys)};", program=program, output=f"{out} = sum;",
                vectorize=True, want={out: [value]})


def _cardio():
    """The SoK batched cardio risk score at n=16384 (tests/
    test_e2e_reference_scale.py:47-100): ten client-evaluated flags packed
    in one ciphertext, padded to 16."""
    v = dict(man=1, woman=0, age=55, smoking=1, diabetic=0,
             high_blood_pressure=1, cholesterol=35, weight=120, height=180,
             daily_physical_activity=20, alcohol=4)
    flags = [int(v["man"] and v["age"] > 50), int(v["woman"] and v["age"] > 40),
             v["smoking"], v["diabetic"], v["high_blood_pressure"],
             int(v["cholesterol"] < 40), int(v["weight"] > v["height"] - 90),
             int(v["daily_physical_activity"] < 30),
             int(v["man"] and v["alcohol"] > 3),
             int(v["woman"] and v["alcohol"] > 2)]
    program = """
      int risk = 0;
      for (int i = 0; i < 10; i = i + 1) {
        risk = risk + flags[i];
      }
      return risk;
    """
    return dict(n=16384, seed=23, program=program,
                inputs=f"secret int flags = {_brace(flags + [0] * 6)};",
                output="out = risk;", vectorize=True,
                want={"out": [sum(flags)]})


def _matvec():
    k = 16
    rng = np.random.default_rng(17)
    m = rng.integers(0, 9, size=(k, k))
    x = [int(v) for v in rng.integers(0, 5, size=k)]
    terms = " + ".join(f"M[16*s+{j}]*x[{j}]" for j in range(k))
    program = f"""
      int y = 0;
      for (int s = 0; s < {k}; s = s + 1) {{
        y[s] = {terms};
      }}
      return y;
    """
    return dict(n=8192, inputs=f"int M = "
                f"{_brace(int(v) for v in m.reshape(-1))}; secret int x = "
                f"{_brace(x + x)};", program=program, output="out = y;",
                vectorize=True,
                want={"out": [int(sum(m[s][j] * x[j] for j in range(k)))
                              for s in range(k)]})


def _roberts():
    size = 8
    img = _image(13, size, 16)
    want = list(img)
    for x in range(size - 1):
        for y in range(size - 1):
            g1 = img[x * size + y] - img[(x + 1) * size + (y + 1)]
            g2 = img[(x + 1) * size + y] - img[x * size + (y + 1)]
            want[x * size + y] = g1 * g1 + g2 * g2
    program = """
      secret int img2 = img;
      for (int x = 0; x < imgSize-1; x = x + 1) {
        for (int y = 0; y < imgSize-1; y = y + 1) {
          secret int g1 = img[x*imgSize+y] - img[(x+1)*imgSize+(y+1)];
          secret int g2 = img[(x+1)*imgSize+y] - img[x*imgSize+(y+1)];
          img2[x*imgSize+y] = g1*g1 + g2*g2;
        }
      }
      return img2;
    """
    return dict(n=8192, inputs=f"secret int img = {_brace(img)}; int "
                f"imgSize = {size};", program=program, output="out = img2;",
                vectorize=False, want={"out": want})


def _kernel(poly):
    x, y, c = [2, -1, 3, 0], [5, 4, -2, 1], 7
    dot = sum(a * b for a, b in zip(x, y))
    program = """
      int sum = 0;
      for (int i = 0; i < n; i = i + 1) { sum = sum + x[i]*y[i]; }
      sum = sum + c;
      return sum;
    """
    if poly:
        program = program.replace("return sum;",
                                  "sum = sum * sum;\n      return sum;")
    return dict(n=8192, inputs=f"secret int x = {_brace(x)}; secret int y = "
                f"{_brace(y)}; int n = 4; int c = 7;", program=program,
                output="k = sum;", vectorize=True,
                want={"k": [(dot + c) ** 2 if poly else dot + c]})


def _smoke():
    pad = [3, 1, 4, 1, 5, 5]                 # last-element padding
    yv = [v * v + 2 * v for v in pad]
    program = """
      secret int y = x*x + 2*x;
      y = y + rotate(y, 1);
      return y;
    """
    return dict(n=4096, inputs="secret int x = {3, 1, 4, 1, 5};",
                program=program, output="out = y;", vectorize=False,
                want={"out": [yv[i] + yv[i + 1] for i in range(5)]})


# name: () -> {n, inputs, program, output, vectorize, want: {output: leading
# slots}[, seed]}: the workloads of tests/test_e2e_reference_scale.py at its
# own parameters and seeds (factory seed 31, its _jit_run's, unless `seed`)
REFERENCE_SCALE = {
    "cardio_n16384": _cardio,
    "hamming16_n8192": lambda: _reduction("hamming", 5, 0, 2,
                                          "(x[i]-y[i])*(x[i]-y[i])", "hd"),
    "boxblur_n8192": lambda: _stencil(11, 256, "weightMatrix", [1] * 9),
    "matvec_bsgs_n8192": _matvec,
    "roberts_cross_n8192": _roberts,
    "linear_kernel_n8192": lambda: _kernel(False),
    "polynomial_kernel_n8192": lambda: _kernel(True),
    "gx_n8192": lambda: _stencil(29, 64, "w", [-1, 0, 1, -2, 0, 2, -1, 0, 1]),
    "gy_n8192": lambda: _stencil(31, 64, "w", [1, 0, -1, 2, 0, -2, 1, 0, -1]),
    "l2_distance_n8192": lambda: _reduction("l2", 37, -20, 20,
                                            "(x[i]-y[i])*(x[i]-y[i])", "d"),
    "dot_product_n8192": lambda: _reduction("dot", 41, -10, 10,
                                            "x[i]*y[i]", "p"),
    "smoke_n4096": _smoke,
}
REFERENCE_SEED = 31


def reference_scale_run(name, dev, reps=3):
    """One workload as a JittedProgram on `dev`: decrypts equal to the
    oracle, the replay's words equal to an eager walk on the same
    ciphertexts, no counter moving across replays. Returns (ms per replay,
    spread, kernels per replay or None, counters after set-up, host-clock
    seconds of set-up / eager walk / replays and profile)."""
    from abc_tpu_torch import CompileOptions, jit_compile_program
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    w = REFERENCE_SCALE[name]()
    t0 = time.perf_counter()
    factory = BfvCiphertextFactory(slots=w["n"], device=dev,
                                   seed=w.get("seed", REFERENCE_SEED))
    jp = jit_compile_program(w["program"], w["inputs"], w["output"],
                             factory=factory,
                             options=CompileOptions(vectorize=w["vectorize"]))
    on_card = jp._graph is not None
    raw = unchanged_across(jp, jp.secret_inputs) if on_card else \
        jp.run_raw(jp.secret_inputs)
    t1 = time.perf_counter()
    eager = jp.run_eager(jp.secret_inputs)
    t2 = time.perf_counter()
    for out in raw:
        check(torch.equal(raw[out], eager[out]),
              f"{name}: replay != eager walk on the same ciphertexts")
    got = jp.decrypt_outputs(raw)
    for out, values in w["want"].items():
        check(got[out][:len(values)] == values,
              f"{name}: {out} decrypts {got[out][:len(values)]} != oracle "
              f"{values}")
    counters = dict(factory.context.counters)
    if not on_card:
        return None, "", None, counters, None
    ms, spread = replay_ms(jp, jp.secret_inputs, reps)
    prof = kernel_profile(lambda: jp.run_raw(jp.secret_inputs), reps=1)
    seconds = (t1 - t0, t2 - t1, time.perf_counter() - t2)
    return ms, spread, None if prof is None else prof[1], counters, seconds


def phase_reference_scale(dev):
    """The workloads of tests/test_e2e_reference_scale.py on the card, each
    as one graph; cardio also through run_compiled. Kernel launches are
    counted over this phase alone."""
    from abc_tpu_torch import (CompileOptions, Parser, compile_program,
                               input_types_from_ast, run_compiled)
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    zero_launches()
    # cardio through the per-op executor, as the reference test runs it
    w = _cardio()
    ia = Parser.parse(w["inputs"])
    compiled = compile_program(w["program"], input_types_from_ast(ia),
                               CompileOptions(vectorize=True))
    check("rotate" in str(compiled.ast), "cardio: no rotate-reduce")
    factory = BfvCiphertextFactory(slots=w["n"], seed=w["seed"], device=dev)
    _, pairs = run_compiled(compiled, ia, Parser.parse(w["output"]), factory)
    got = factory.decrypt(pairs[0][1])[0]
    c = factory.context.counters
    check(got == w["want"]["out"][0], f"cardio run_compiled: {got} != "
          f"{w['want']}")
    check(c["galois"] >= 4 and c["mult"] == 0, f"cardio counters {c}")
    print(f"  cardio_n16384 through run_compiled: {got} = oracle; counters "
          f"{dict(c)}", flush=True)
    for name in REFERENCE_SCALE:
        ms, spread, kernels, c, secs = reference_scale_run(name, dev)
        if name.startswith("cardio"):
            check(c["galois"] >= 4 and c["mult"] == 0,
                  f"cardio as a graph: counters {c}")
        print(f"  {name}: decrypts equal to the oracle, replay equal to an "
              f"eager walk, no counter moving; {ms:.3f} ms per replay (CUDA "
              f"events, median of 3, {spread}); "
              f"{'not measured' if kernels is None else f'{kernels:.0f}'} "
              f"kernels per replay; host clock s: set-up (keys, warm-up, "
              f"capture, first replay) {secs[0]:.1f}, eager walk "
              f"{secs[1]:.1f}, replays and profile {secs[2]:.1f}",
              flush=True)
    launches = launch_counts()
    # BFV workloads, none of which negates a ciphertext
    check_launched(launches, "phase 12",
                   absent=BFV_ABSENT + ("rns_ew_neg",) + MESH_K)
    return launches


# ------------------------------------------------------ phase 13: the meshes
# the reference's production shapes (abc_tpu/parallel/dryrun.py:89-130):
# BFV n=8192 with 8 data primes + 1 special (build_context(8192, 8,
# seed=17)) on dp=2 x limb=4; the distributed NTT at n=32768, L=8 over D=8
# shards (S = 4096); CKKS n=32768, levels=8, k=1 over D=8
MESH_DP, MESH_LIMB = 2, 4
MESH_BFV = {"n": 8192, "limbs": 8, "seed": 17}
MESH_NTT = {"n": 32768, "L": 8, "D": 8}
MESH_CKKS = {"n": 32768, "levels": 8, "seed": 23, "D": 8}
MESH_BATCH = 4
# the sharded CKKS op's graph (c): the single-device op's kernels and one
# combine a stage of its five distributed transforms
MESH_CKKS_CENSUS = {**CKKS_OP_CENSUS, "dist_ntt_combine":
                    5 * (MESH_CKKS["D"].bit_length() - 1)}
# the shapes of the kernels line's K8 entries (k8_calls's labels)
K8_JSON = {"dist_ntt_combine": "combine fwd (c) digits",
           "rns_psum_mod": "psum rank form (a)"}


def is_copy(kernel):
    """Whether a kernel that is not hand-written only moves words: torch's
    copy kernels (a .contiguous(), a clone, a cat or stack, a gather's
    layout) name themselves so."""
    return "copy" in kernel.lower()


def k8_calls(dev, edge=None):
    """{label: (kernel, kernel call, plain call, bytes, integer
    multiply-adds, library call or None, shape)} of the mesh kernels (K8)
    at the mesh paths' shapes, their operands where the paths read them:
    the combine of the distributed NTT (b) (MESH_NTT: [D, L, S] a view of
    one polynomial), of the CKKS op's digits (c) ([L digits, D, L+1, S]:
    the lift's output with the digit axis moved in front, the largest
    transform of the op) and its accumulators' last inverse stage with n^-1
    folded, written as [D, 2, L+1, S]; the psum of the limb-sharded key
    switch (a) (MESH_BFV: one half of [limb, 2, L+1, n]) into its half of
    the summed pair, over D = 8 shards of MESH_NTT's blocks, and the rank
    form on the int64 sums an all_reduce of (a)'s four shards makes. With
    0 and q-1 among random residues, or every word q-1 (`edge` "max"). The
    bound counts each input once (a combine reads each word twice, as x
    and as a partner), each output once, the tables, and a Shoup product
    (3 multiply-adds) a coefficient where one is made. The rank form's
    library call is torch.remainder, which computes its int64 residues in
    one call; nothing else has one."""
    from abc_tpu_torch.crypto.ckks import CkksParams
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.ops import mesh_kernels as mk
    from abc_tpu_torch.parallel.dist_ntt import DistNttContext
    from abc_tpu_torch.parallel.mesh import coeff_mesh

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def residues(moduli, lead, n, seed):
        """[*lead, len(moduli), n] residues."""
        qcol = torch.tensor(moduli, dtype=torch.int64).reshape(-1, 1)
        shape = lead + (len(moduli), n)
        if edge == "max":
            x = torch.zeros(shape, dtype=torch.int64) + qcol - 1
            return x.to(torch.int32).to(dev)
        x = rand_residues(moduli, shape, seed, dev)
        x[..., 0] = 0
        x[..., 1::257] = (qcol - 1).to(torch.int32).to(dev)
        return x

    calls = {}

    def combine(label, dist, b, x, forward, out=None):
        t_sh = dist.D // 2                       # stage 0
        tw = (b["fwd"] if forward else b["inv"])[0]
        u = None if forward else b["n_inv"]
        words = x.numel()
        calls[label] = (
            "dist_ntt_combine",
            lambda: mk.dist_ntt_combine(x, tw, dist.q_col, t_sh, forward,
                                        u=u, out=out),
            lambda: mk.combine_plain(x, tw[0], dist.q_col, t_sh, forward,
                                     u=None if u is None else u[0]),
            4 * 2 * words + nbytes(*tw, dist.q_col, *(u or ())),
            3 * words, None, ["forward" if forward else "inverse"]
            + list(x.shape))

    # (b) the distributed NTT's forward, one [L, n] polynomial over D
    n, D, L = MESH_NTT["n"], MESH_NTT["D"], MESH_NTT["L"]
    moduli = gen_ntt_primes(30, L, n)
    dist = DistNttContext(NttContext(n, moduli, dev), D)
    mesh = coeff_mesh(D, device=dev)
    b = dist.bind(mesh)
    combine("combine fwd (b)", dist, b,
            mesh.scatter(residues(moduli, (), n, 1), "coeff", dim=-1), True)
    # (c) the CKKS op's digit transform and its accumulators' last stage
    p = CkksParams.create(MESH_CKKS["n"], levels=MESH_CKKS["levels"],
                          seed=MESH_CKKS["seed"])
    cols = p.data_primes + p.special_primes
    S = MESH_CKKS["n"] // MESH_CKKS["D"]
    dqp = DistNttContext(NttContext(MESH_CKKS["n"], cols, dev),
                         MESH_CKKS["D"])
    bqp = dqp.bind(coeff_mesh(MESH_CKKS["D"], device=dev))
    lifted = residues(cols, (MESH_CKKS["D"], p.L), S, 2)
    combine("combine fwd (c) digits", dqp, bqp, lifted.movedim(-4, -3),
            True)
    acc = residues(cols, (2, MESH_CKKS["D"]), S, 3)
    halves = torch.empty((MESH_CKKS["D"], 2, len(cols), S),
                         dtype=torch.int32, device=dev)
    combine("combine inv (c) accumulators, n^-1 folded", dqp, bqp, acc,
            False, out=halves.movedim(0, 1))

    # (a) the limb psum: one half of [limb, 2, L+1, n] into its half
    n_b = MESH_BFV["n"]
    t = gen_ntt_primes(20, 1, n_b)[0]
    primes = gen_ntt_primes(30, MESH_BFV["limbs"] + 1, n_b, exclude=[t])
    q = torch.tensor(primes, dtype=torch.int32, device=dev).reshape(-1, 1)
    q64 = q.to(torch.int64)
    part = residues(primes, (MESH_LIMB, 2), n_b, 4)
    summed = torch.empty((2, len(primes), n_b), dtype=torch.int32,
                         device=dev)
    words = summed.numel() // 2
    calls["psum (a)"] = (
        "rns_psum_mod",
        lambda: mk.rns_psum_mod(part[:, 0], q, out=summed[0]),
        lambda: mk.psum_plain(part[:, 0], q),
        4 * (MESH_LIMB + 1) * words + nbytes(q), 0, None,
        ["local", MESH_LIMB, len(primes), n_b])
    wide = part[:, 0].to(torch.int64).sum(dim=0)
    calls["psum rank form (a)"] = (
        "rns_psum_mod", lambda: mk.rns_psum_mod(wide, q),
        lambda: mk.psum_plain(wide, q), (8 + 4) * words + nbytes(q), 0,
        lambda: torch.remainder(wide, q64), ["rank", len(primes), n_b])
    # over D = 8 shards of MESH_NTT's blocks
    blocks = residues(moduli, (D,), n // D, 5)
    calls["psum D=8"] = (
        "rns_psum_mod", lambda: mk.rns_psum_mod(blocks, dist.q_col),
        lambda: mk.psum_plain(blocks, dist.q_col),
        4 * (D + 1) * blocks.numel() // D + nbytes(dist.q_col), 0, None,
        ["local", D, L, n // D])
    return calls


def k8_calls_kernel(label):
    """The kernel a k8_calls label times."""
    return "dist_ntt_combine" if label.startswith("combine") else \
        "rns_psum_mod"


def phase_k8(dev):
    """The mesh kernels' compiler census; the kernels against their plain
    versions at the mesh paths' shapes (k8_calls), on random and
    all-(q-1) inputs; times and bounds.
    Returns ({kernel: the kernels line's stats}, {label: stats of the other
    shapes})."""
    from abc_tpu_torch.ops import _build
    from abc_tpu_torch.ops import kernel_census as kc

    table = kc.kernel_table(_build.build_log, _build.sass(), prefix=kc.MESH)
    check(len(table) >= 4, f"no ptxas / SASS record of the mesh kernels: "
          f"{sorted(table)}")
    for key, row in table.items():
        print(f"  {key}: {kc.fmt_kernel(row)}", flush=True)
    k8 = {name: {"max_abs_err": 0} for name in MESH_K}
    extra = {}
    for edge in (None, "max"):
        for label, (name, kern, plain, n_bytes, imads, library, at) in \
                k8_calls(dev, edge).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            k8[name]["max_abs_err"] = max(k8[name]["max_abs_err"], err)
            check(torch.equal(got, want), f"{label} != plain"
                  + (" on all-(q-1) inputs" if edge else ""))
            if edge is not None:
                continue
            st = {}
            line = _timed(st, kern, plain, at, bound(n_bytes, imads), library)
            print(f"  {label} {at} = plain; {line}", flush=True)
            if K8_JSON[name] == label:
                k8[name].update(st)
            else:
                extra[label] = st
    print("  every K8 form = plain on all-(q-1) inputs too", flush=True)
    return k8, extra


def mesh_nccl_leg(dev, local_words):
    """(a) and (b) on DistComm over NCCL: world = the visible cards, one rank
    each, spawned; each rank's words against the LocalComm words of this
    process; the rank forms of the mesh kernels against their plain
    versions on every rank (multihost.run_mesh_kernels; a world of 1 runs
    no exchange), with the mesh kernels each rank launched. Last in the
    same ranks, whether an NCCL all_reduce can be captured in a graph (a
    probe, reported whatever it finds)."""
    import tempfile

    from abc_tpu_torch.parallel import multihost

    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as words_dir:
        results = multihost.launch(
            nproc=1, local_devices=world,
            tasks=("keyswitch", "ntt", "mesh_kernels", "capture_probe"),
            device="cuda", n_bfv=MESH_BFV["n"], bfv_limbs=MESH_BFV["limbs"],
            n_ntt=MESH_NTT["n"], ntt_limbs=MESH_NTT["L"], timeout_s=180,
            words_dir=words_dir)
        for r in range(world):
            got = np.load(os.path.join(words_dir, f"rank{r}.npz"))
            for name, want in local_words.items():
                check(np.array_equal(got[name], want),
                      f"NCCL rank {r}: {name} != the LocalComm words")
    r0 = results[0]
    check(r0["backend"] == "nccl" and r0["barrier"]["world"] == world,
          f"NCCL leg: {r0['backend']}, barrier {r0['barrier']}")
    ks = r0["keyswitch"]["collectives"]
    exchanges = r0["ntt"]["collectives"].get("collective-permute",
                                             {"ops": 0})["ops"]
    print(f"  NCCL leg: world {world} (one rank per card), mesh "
          f"{r0['keyswitch']['mesh']}, D={r0['ntt']['D']}: sharded key "
          f"switch, rotation and the distributed NTT word-equal to LocalComm "
          f"on every rank; collectives {ks}, {exchanges} exchanges"
          + (" (a world of 1 covers NCCL init and all_reduce, and no "
             "exchange)" if world == 1 else ""), flush=True)
    for r in results:
        mkr, got = r["mesh_kernels"], r["launches"]
        check(mkr["combines_checked"] > 0 and mkr["psum_checked"] and
              all(got[k] > 0 for k in MESH_K),
              f"NCCL rank {r['process_id']}: mesh kernels {mkr}, launched "
              f"{got}")
    print(f"  NCCL leg: the rank forms of the mesh kernels = plain on every "
          f"rank at n={MESH_NTT['n']}, L={MESH_NTT['L']}, D={MESH_NTT['D']} "
          f"({results[0]['mesh_kernels']['combines_checked']} combines "
          f"with a partner block, the psum of int64 sums); launches per rank "
          f"{[r['launches'] for r in results]}", flush=True)
    print(f"  NCCL all_reduce under torch.cuda.graph: "
          f"{[r['nccl_capture'] for r in results]}", flush=True)


def phase_mesh(dev):
    """Phase 13: the mesh paths on LocalComm on the card at production
    shapes, word for word against the single-device port; the shard-table
    launches against the plain versions; then DistComm over NCCL. Launches
    are counted over the driven mesh path alone."""
    from abc_tpu_torch import entry, jit_compile_program
    from abc_tpu_torch.crypto.ckks import CkksContext, CkksParams
    from abc_tpu_torch.crypto.ntt import NttContext
    from abc_tpu_torch.crypto.numthy import gen_ntt_primes
    from abc_tpu_torch.ops import ntt_kernels as nk
    from abc_tpu_torch.ops.modarith import to_host
    from abc_tpu_torch.parallel import (make_mesh, multihost,
                                        sharded_key_switch,
                                        sharded_rotate_rows)
    from abc_tpu_torch.parallel.dist_ckks import DistCkksMultiplier
    from abc_tpu_torch.parallel.dist_ntt import DistNttContext
    from abc_tpu_torch.parallel.dryrun import HAMMING, build_context
    from abc_tpu_torch.parallel.mesh import coeff_mesh
    from abc_tpu_torch.runtime.bfv_backend import BfvCiphertextFactory

    mesh = make_mesh(MESH_DP, MESH_LIMB, device=dev)
    n, D, L = MESH_NTT["n"], MESH_NTT["D"], MESH_NTT["L"]
    S = n // D
    moduli = gen_ntt_primes(30, L, n)
    nctx = NttContext(n, moduli, dev)
    dist = DistNttContext(nctx, D)
    cmesh = coeff_mesh(D, device=dev)
    x, y = multihost.ntt_inputs(moduli, n, 0, dev)

    # --- the shard-table launches against the plain versions (not counted)
    b = dist.bind(cmesh)
    flat = cmesh.scatter(x, "coeff", dim=-1).contiguous().flatten(-3, -2)
    rows = flat.shape[-2]
    stats = {}
    for name, kern, plain in (
            ("ntt_fwd",
             lambda: nk.ntt_fwd(flat, b["q"], b["loc_f"], b["loc_fs"]),
             lambda: nk.fwd_ntt_plain(flat, b["q"], b["loc_f"])),
            ("ntt_inv",
             lambda: nk.ntt_inv(flat, b["q"], b["loc_i"], b["loc_is"],
                                b["unit"], b["unit_sh"]),
             lambda: nk.inv_ntt_plain(flat, b["q"], b["loc_i"], b["unit"]))):
        k_out, p_out = kern(), plain()
        check(torch.equal(k_out, p_out),
              f"{name} with the shard tables != plain at {rows} rows, n={S}")
        st = {"max_abs_err": int((k_out.long() - p_out.long()).abs().max())}
        line = _timed(st, kern, plain, [S, rows, 1],
                      ntt_bound(S, rows, rows, name == "ntt_inv"))
        stats[name] = st
        print(f"  {name}, {D} shards' tables in one launch: {rows} rows x "
              f"n={S} ({nk.cluster_size(rows, S)} CTAs per row) = plain; "
              f"{line}", flush=True)

    # --- the mesh kernels (K8) at the paths' shapes (not counted)
    k8, k8_extra = phase_k8(dev)
    for label, st in k8_extra.items():
        stats.setdefault(k8_calls_kernel(label), {})[label] = st

    last = [time.perf_counter()]

    def secs():
        """Host-clock seconds of the part just done."""
        now = time.perf_counter()
        took, last[0] = now - last[0], now
        return f"{took:.1f} s on the host clock"

    zero_launches()
    # --- (a) limb-sharded key switch and rotation, BFV n=8192, 8 + 1 primes
    ctx = build_context(MESH_BFV["n"], MESH_BFV["limbs"],
                        seed=MESH_BFV["seed"], device=dev)
    ct = ctx.encrypt(ctx.encode(list(range(16))))
    ksk = ctx.get_relin_key()
    k0, k1 = sharded_key_switch(ctx, mesh, ct.data[1], ksk)
    r0, r1 = ctx._key_switch(ct.data[1], ksk)
    check(torch.equal(k0, r0) and torch.equal(k1, r1),
          "sharded key switch != the single-device _key_switch")
    rot = sharded_rotate_rows(ctx, mesh, ct.data, 3)
    check(torch.equal(rot, ctx.rotate_rows(ct, 3).data),
          "sharded rotation != the single-device rotate_rows")
    check(ctx.decode(ctx.decrypt(type(ct)(rot)))[:13] == list(range(3, 16)),
          "sharded rotation does not decrypt to the rotated slots")
    print(f"  (a) BFV n={MESH_BFV['n']}, L={ctx.params.L}, dp={MESH_DP} x "
          f"limb={MESH_LIMB}: sharded_key_switch and sharded_rotate_rows "
          f"equal the single-device words; collectives {mesh.census}; "
          f"{secs()}", flush=True)

    # --- (b) the distributed NTT, n=32768, L=8, D=8
    before = dict(nk.launches)
    f = dist.make_fwd(cmesh)(x)
    check(nk.launches["ntt_fwd"] == before["ntt_fwd"] + 1
          and nk.launches["ntt_inv"] == before["ntt_inv"],
          "the distributed forward NTT is not one launch for all shards")
    check(torch.equal(f, nctx.fwd(x)), "distributed fwd != NttContext.fwd")
    inv_x = dist.make_inv(cmesh)(x)
    check(torch.equal(inv_x, nctx.inv(x)), "distributed inv != NttContext.inv")
    check(torch.equal(dist.make_inv(cmesh)(f), x), "inv(fwd(x)) != x")
    mul = dist.make_negacyclic_mul(cmesh)(x, y)
    check(torch.equal(mul, nctx.negacyclic_mul(x, y)),
          "distributed negacyclic_mul != NttContext.negacyclic_mul")
    print(f"  (b) distributed NTT n={n}, L={L}, D={D} (S={S}): fwd, inv, "
          f"negacyclic_mul equal NttContext; collectives {cmesh.census}; "
          f"{secs()}", flush=True)

    # --- (c) the coefficient-sharded CKKS multiply, n=32768, levels=8, k=1
    cctx = CkksContext(CkksParams.create(MESH_CKKS["n"],
                                         levels=MESH_CKKS["levels"],
                                         seed=MESH_CKKS["seed"]), dev)
    dmul = DistCkksMultiplier(cctx, coeff_mesh(MESH_CKKS["D"], device=dev))
    vals = np.linspace(0.1, 0.9, 64)
    ca, cb = cctx.encrypt(cctx.encode(vals)), cctx.encrypt(cctx.encode(vals))
    before = launch_counts()
    prod = dmul(ca.data, cb.data)
    check(since(before) == MESH_CKKS_CENSUS,
          f"the sharded CKKS op launched {since(before)}, not "
          f"{MESH_CKKS_CENSUS}")
    check(torch.equal(prod, cctx.multiply(ca, cb, rescale=False).data),
          "DistCkksMultiplier != CkksContext.multiply(rescale=False)")
    ckks_ms = cuda_ms(lambda: dmul(ca.data, cb.data))
    ckks_prof = kernel_profile(lambda: dmul(ca.data, cb.data), reps=3)
    # its census from the node list of the op captured as a graph
    from abc_tpu_torch.utils.timing import graph_of
    g = graph_of(lambda x: dmul(x, cb.data), ca.data)
    g.replay()
    check(torch.equal(g.output, prod), "the sharded CKKS op's replay != "
          "its eager words")
    c_kernels, c_other, c_nodes = graph_census(
        g, MESH_CKKS_CENSUS, "the sharded CKKS op's graph")
    check(c_kernels <= 100 and all(is_copy(k) for k in c_other),
          f"the sharded CKKS op's graph: {c_kernels} kernels (at most 100), "
          f"not hand-written {c_other}")
    c_replay = cuda_ms(g.replay)
    print(f"  (c) CKKS n={MESH_CKKS['n']}, levels={MESH_CKKS['levels']}, "
          f"k=1, D={MESH_CKKS['D']}: DistCkksMultiplier equals "
          f"CkksContext.multiply(rescale=False); {ckks_ms:.3f} ms per eager "
          f"call (CUDA events, median of 10); device: {fmt_ntt(ckks_prof)}; "
          f"as a graph {c_kernels} kernel nodes: the hand-written "
          f"{ {k: v for k, v in MESH_CKKS_CENSUS.items() if v} } and the "
          f"copies {c_other}, other nodes {c_nodes}; {c_replay:.3f} ms per "
          f"replay; {secs()}", flush=True)
    del g

    # --- (d) the hamming program on the dp x limb mesh as one graph
    rng = np.random.default_rng(3)
    xs = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(MESH_BATCH)]
    ys = [[int(v) for v in rng.integers(0, 2, 4)] for _ in range(MESH_BATCH)]

    def inputs(xv, yv):
        return (f"secret int x = {{{','.join(map(str, xv))}}}; "
                f"secret int y = {{{','.join(map(str, yv))}}}; int n = 4;")

    jp = jit_compile_program(HAMMING, inputs(xs[0], ys[0]), "out = sum;",
                             BfvCiphertextFactory(context=ctx), mesh=mesh,
                             batch_values={"x": xs, "y": ys})
    check(jp._graph is not None and jp._limb_ok,
          "the mesh program was not captured limb-sharded")
    raw = jp.run_raw(jp.secret_inputs)
    got = [r[0] for r in jp.decrypt_outputs(raw)["out"]]
    single = jit_compile_program(
        HAMMING, inputs(xs[0], ys[0]), "out = sum;",
        BfvCiphertextFactory(context=build_context(
            MESH_BFV["n"], MESH_BFV["limbs"], seed=MESH_BFV["seed"],
            device=dev)))
    singles = [single.decrypt_outputs(single.run_raw(single.encrypt_inputs(
        {"x": xv, "y": yv})))["out"][0] for xv, yv in zip(xs, ys)]
    oracle = [sum(int(p != q) for p, q in zip(xv, yv))
              for xv, yv in zip(xs, ys)]
    check(got == singles == oracle,
          f"mesh hamming {got}, single-device {singles}, oracle {oracle}")
    per_walk = walk_launches(jp)
    check(per_walk["rns_psum_mod"] > 0, f"the mesh program's walk ran no "
          f"psum: {per_walk}")
    d_kernels, d_other, d_nodes = graph_census(
        jp._graph, per_walk, "the mesh program's graph, whose walk launches "
        f"the hand-written kernels {per_walk},")
    check(all(is_copy(k) for k in d_other), f"the mesh program's graph runs "
          f"kernels that are neither hand-written nor copies: {d_other}")
    counts = launch_counts()
    replay = replay_ms(jp, jp.secret_inputs, 10)
    check(launch_counts() == counts, "a mesh replay moved a launch count")
    prof = kernel_profile(lambda: jp.run_raw(jp.secret_inputs), reps=3)
    print(f"  (d) hamming on dp={MESH_DP} x limb={MESH_LIMB}, n="
          f"{MESH_BFV['n']}, batch {MESH_BATCH}: one graph, decrypts "
          f"{got} = the single-device runs = oracle; {replay[0]:.3f} ms per "
          f"replay (CUDA events, median of 10, {replay[1]}); device: "
          f"{fmt_ntt(prof)}; graph {d_kernels} kernel nodes: the "
          f"hand-written { {k: v for k, v in per_walk.items() if v} }, the "
          f"copies {d_other}, other nodes {d_nodes}; phase_ms "
          f"{ {k: round(v, 1) for k, v in jp.phase_ms.items()} }; "
          f"{secs()}", flush=True)

    # --- (e) the entry point: entry.dryrun_multichip(8)
    report = entry.dryrun_multichip(MESH_DP * MESH_LIMB)["production"]
    for part in ("bfv", "compiled_program", "ckks"):
        print(f"  (e) production {part}: step {report[part]['step_ms']:.3f} "
              f"ms ({report[part]['timer']}); collectives per step "
              f"{report[part]['collectives_per_step']}", flush=True)
    print(f"  (e) {secs()}", flush=True)
    launches = launch_counts()
    # no path of the meshes negates (the distributed negacyclic_mul's
    # pointwise product is rns_ew_mul)
    check_launched(launches, "phase 13", absent=("rns_ew_neg",))

    # --- DistComm over NCCL: (a) and (b) on spawned ranks
    local_words = {"keyswitch.k0": to_host(k0), "keyswitch.k1": to_host(k1),
                   "keyswitch.rot": to_host(rot), "ntt.fwd": to_host(f),
                   "ntt.inv": to_host(inv_x), "ntt.mul": to_host(mul)}
    mesh_nccl_leg(dev, local_words)
    print(f"  NCCL leg {secs()}", flush=True)
    return stats, launches, k8


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from abc_tpu_torch.ops import _build

    # CUPTI stays set up between profiles, as torch.profiler sets it for
    # CUDA graphs under CUDA < 12.6 (its note: graphs do not work well with
    # CUPTI's teardown); profiles only time, a census reads a graph's nodes
    os.environ["TEARDOWN_CUPTI"] = "0"
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"card: {smi[0]}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    _build.build()
    print(f"kernel build: {_build.build_seconds:.1f} s (nvcc, sm_90a)",
          flush=True)
    print("\n".join("  " + ln for ln in _build.build_log.splitlines()
                    if "registers" in ln or "spill" in ln), flush=True)
    _build.load()
    gold = golden()

    clock = [time.perf_counter()]

    def announce(title):
        """Print a phase's title after the seconds the one before it took."""
        now = time.perf_counter()
        print(f"  ({now - clock[0]:.1f} s on the host clock)\n{title}",
              flush=True)
        clock[0] = now

    announce("phase 2: kernels vs plain")
    stats = phase_kernels(dev)
    announce("phase 2b: the BEHZ kernels vs plain")
    stats.update(phase_behz(dev))
    announce("phase 2c: the key-switch kernels vs plain")
    stats.update(phase_keyswitch(dev))
    announce("phase 2d: the key generation, encryption and decryption "
             "kernels vs plain")
    stats.update(phase_rlwe(dev))
    announce("phase 2e: the K9 kernels (ks_mod_down's relinearization and "
             "rotation tails, the RNS elementwise ops) vs plain")
    stats.update(phase_elementwise(dev))
    announce("phase 3: mult+relin n=8192")
    mult_eager = {k: phase_mult_relin(dev, k, gold[f"mult_relin_n8192_k{k}"])
                  for k in (1, 2)}
    announce("phase 4: main path (README hamming, n=8192)")
    launches, hamming_words = phase_hamming(dev, gold["hamming_n8192"])
    announce("phase 5: LaplaceSharpening n=16384")
    laplace_ctx, laplace_words, laplace_eager_ms = phase_laplace(dev)
    announce("phase 6: keygen and switching keys on the card")
    keys_launches = phase_keys(dev, laplace_ctx)
    del laplace_ctx
    announce("phase 7: NTT ablation and ALU calibration")
    abl_stats, abl_launches = phase_ablation(dev)
    stats.update(abl_stats)
    launches.update(abl_launches)
    announce("phase 8: whole-program execution (one CUDA graph per program)")
    graph_launches = phase_whole_program(dev, gold, hamming_words,
                                         laplace_words, laplace_eager_ms,
                                         mult_eager[1])
    announce("phase 8b: two captured programs of two contexts, replayed in "
             "turns")
    phase_two_programs(dev, gold)
    announce("phase 9: CKKS (n=32768, 8 + 2 primes; leveled views, the "
             "config-5 op, float programs as graphs, the packed matvec)")
    ckks_stats, ckks_launches = phase_ckks(dev, gold)
    announce("phase 10: the measurement entry point (batch contract, "
             "python -m abc_tpu_torch.bench --quick in process)")
    bench_launches, bench_abl_launches = phase_bench(dev, gold)
    bench_launches.update(bench_abl_launches)
    announce("phase 11: checkpoint / resume as a serving path (a client "
             "here, a server process that reads only its files)")
    serving_launches = phase_checkpoint(dev, gold)
    announce("phase 12: the reference-scale workloads as graphs")
    reference_scale_launches = phase_reference_scale(dev)
    announce("phase 13: the meshes (LocalComm on the card at production "
             "shapes; DistComm over NCCL)")
    mesh_stats, mesh_launches, k8_stats = phase_mesh(dev)
    stats.update(k8_stats)
    announce("phases done")
    loaded = sorted(m for m, v in sys.modules.items() if v is not None
                    and m.split(".")[0] in ("jax", "jaxlib", "abc_tpu"))
    check(not loaded, f"the reference or JAX was imported: {loaded}")

    # no single PyTorch call computes a negacyclic NTT mod q, these ALU
    # chains, a modular RNS base conversion, a mod-q tensor product, a
    # mod-q contraction, an exact division by a prime (with or without a
    # relinearization's or a rotation's tail), Threefry words, a switching
    # key, the encryption's lift with its adds, the BFV scale-and-round or
    # a modular add, subtract, negation or product, or the distributed
    # NTT's combine, so these kernels have no library yardstick;
    # ks_decompose's k = 1 lift, its shape here, is one torch.remainder
    # (phase 2c), and so is rns_psum_mod's rank form, its shape here
    # (phase 13)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name],
                # the key generation, encryption and decryption kernels'
                # own path is phase 6's (keys, an encryption, a decryption,
                # a uniform regeneration), ks_mod_down's the CKKS path's
                # (the rescale: a BFV key switch ends in a tail), the mesh
                # kernels' the mesh paths' (phase 13), every other
                # kernel's phase 4's
                "launches": (keys_launches if name in RLWE else
                             ckks_launches if name in BFV_ABSENT else
                             mesh_launches if name in MESH_K else
                             launches)[name],
                "launches_keys": keys_launches.get(name, 0),
                # the whole-program path counts while it sets up, warms up
                # and captures, and never at a replay
                "launches_whole_program": graph_launches.get(name, 0),
                # the CKKS path (phase 9), counted alone, and the kernel at
                # the largest launch shape of the CKKS op
                "launches_ckks": ckks_launches.get(name, 0),
                # the measurement entry point (phase 10), counted alone: it
                # times ntt_fwd / ntt_inv and never the ablation's kernels
                "launches_bench": bench_launches.get(name, 0),
                # the server of phase 11 (its own process, both schemes) and
                # the reference-scale workloads of phase 12, each alone
                "launches_serving": serving_launches.get(name, 0),
                "launches_reference_scale":
                    reference_scale_launches.get(name, 0),
                # phase 13's mesh paths, counted alone, and the kernel with
                # D shards' tables in one launch at n = S (the local stages
                # of the distributed NTT)
                "launches_mesh": mesh_launches.get(name, 0),
                "mesh": mesh_stats.get(name),
                "ckks": ckks_stats.get(name),
                "max_abs_err": stats[name]["max_abs_err"],
                "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"],
                "bound_ms": stats[name]["bound_ms"],
                "bound_by": stats[name]["bound_by"],
                "library_ms": stats[name].get("library_ms"),
                "library_device_ms": stats[name].get("library_device_ms"),
                "device_ms": stats[name]["device_ms"],
                # the same call with the L2 flushed before it: against the
                # DRAM bound where "device_ms" may read under it
                "cold_ms": stats[name].get("cold_ms"),
                "cold_device_ms": stats[name].get("cold_device_ms"),
                "plain_device_ms": stats[name]["plain_device_ms"],
                "at": stats[name].get("at", list(JSON_SHAPE.get(name, ()))),
                # the BEHZ and key-switch kernels' launch at "at" and what
                # the compiler made of it (phases 2b, 2c)
                "launch": stats[name].get("launch")}
               for name in ("ntt_fwd", "ntt_inv", "ablate_ntt",
                            "alu_chain") + BEHZ + KS + RLWE + K9A + K9B
               + MESH_K]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi[0]}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve"]:
        # phase 11's server, in a process of its own
        serve(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
