#!/usr/bin/env python3
"""Drive the tpu3fs_torch data plane, chain-table placement, storage tier,
serving stack, KV-cache tier, checkpoints, data loading, concurrent fetch,
readahead, the trace sink, the services over sockets, the USRBIO
shared-memory rings, the native paths, the operator's entry points, the
chaos search, the thousand-node scale fabric, the template service, the
ICI chain transport, the EC mesh rebuild and the multi-rank checkpoint
save on one CUDA card.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero):
  1. environment: the card's name and power limit, torch and CUDA versions,
     /dev/shm's size and free space and the library of sem_open;
  2. build: the kernel library from tpu3fs_torch/csrc with nvcc;
  3. K1: layout probes (a unit matrix, single set bits), then both kernels
     (the tensor-core gf2_matmul and gf2_matmul_bitslice) against the plain
     PyTorch version, byte for byte, and the numpy gold encode/reconstruct;
     a ragged S and an unaligned base must take the bit-sliced kernel;
  4. K2: a probe (one set bit at each offset of a block), then both kernels
     (the tensor-core crc32c_blocks and crc32c_blocks_table) against the
     plain version and the scalar crc32c_py; block 1000, a 9-byte row and an
     unaligned base must take the table kernel;
  5. K3: the XOR-rebuild kernel xor_reduce against xor_reduce_plain at the
     rebuild shape, k of 2, 7 and 12, a ragged S and an unaligned base;
  6. K4 and K5: the chain ring's fold checksum xor_fold_crc (a byte probe
     at every offset and base alignment, S % 4 of 0-3, S = 0, B = 0, and
     every shape of FOLD_SHAPES at base offsets 0-15) against its plain
     version and the earlier atomic kernel (xor_fold_crc_atomic), then one call per
     shape captured in a CUDA graph and replayed on three fresh inputs;
     the full-Gram placement scorer score_batch (pair
     probes across the Gram's tiles, v of 1, 7, 13 and 180 x b of 2, 37 and
     5760 x P of 1, 3 and 128, with and without domains, signed values, an
     unaligned base, zero-size work), each against its plain version; then
     the swap scorer swap_score (v = 180 at k of 3, 16 and 1, with 0, 18, 60
     and 180 domains, invalid moves, an ssq past 2**31, max ties; P of 1, 3
     and 128) against its plain version and the full-Gram kernel on the
     materialised proposals, and swap_apply over 500 accepted moves (and 100
     at the CR shape, 50 past 2**31), each state equal to its plain twin and
     to a fresh build from the table after every move;
  7. the stripe server answering requests through StripeCodec(12, 4, 1 MiB):
     writes, a verify, degraded reads, a rebuild over a 1 GiB device store
     and a 4 MiB chunk;
  8. the codec's chain-encode hops: delta_parity and hop_accumulate (numpy
     and device accumulators) at RS(12,4), S = 1 MiB, B = 12, against the
     plain versions on the CPU;
  9. the multi-device path on a one-rank NCCL group: dryrun_multichip (its
     chain write checksummed by K4), a chain write of 12 x 1 MiB rows
     checksummed by BatchCrc32c (K2) and an all-to-all shuffle. One card
     holds one NCCL rank, so the chain ring and the rebuild's all-gather
     (chain > 1) are not reached here: they are held against the JAX
     package on gloo ranks by tests/test_torch_parallel.py;
 10. the storage tier answering requests: crc32c_many (one K2 launch over
     front-padded rows) against crc32c_py at lengths 0, 1, 511, 512, 513,
     349,696 and 1 MiB + 3; then 16 StorageServices in one process over a
     hand-made RoutingInfo and a direct-dispatch messenger (in_process):
     (1) a CR chain of 3 takes 64 chunks of 1 MiB with batch_write and 32
     partial overwrites, and every replica reads back the bytes written,
     with equal versions and checksums; (2) 16 RS(12,4) stripes of 4 MiB
     (S = 349,696) are encoded here and staged and committed through
     batch_write_shard; (3) the same 16 go through chain_encode, and every
     stored shard equals its client-encoded twin; (4) with data shard 1 and
     parity shard 12 down, all 32 stripes read back through decodes;
     (5) EcResyncWorker.run_once rebuilds shard 1 onto an empty engine, each
     shard and CRC equal to the original; (6) the CR tail misses 32 writes,
     re-joins and ResyncWorker brings it back, serving the same bytes.
     Steps 1-6 run on the card (the main path; K1 and K2 must launch and no
     plain version run), on the CPU with the plain versions and, after
     phase 15's traces, again on the card under torch.profiler (each
     request's device time): all three must give the same replies, bytes,
     versions and checksums;
 11. the serving stack answering files through Fabric.meta and
     Fabric.file_client() (Fabric(cfg, device)): RS(12,4) over 4 storage
     nodes and 2 chains, 1 MiB stripes (S = 87,552), 48 a pass, as the
     JAX package's serving benchmark (bench.py:286-337): (1) write /a, 48
     full stripes through write_stripes; (2) read it; (3) one partial
     overwrite inside stripe 1 (the delta-parity read-modify-write); (4)
     fail the first node (4 shards of every stripe); (5) read /a degraded
     (a K1 decode of 4 lost); (6) restart the node on empty engines and
     resync_all(rounds=6) (the EC rebuild); (7) read /a; (8) write and
     read /b with TPU3FS_EC_CHAIN_ENCODE=1 (the chain-encode hops); (9)
     write and read /cr on a CR fabric at storage_bench's shape (2
     replicas, 4 chains, 64 chunks of 256 KiB). A full-size warm-up pass
     on its own fabric comes first. Every byte read is checked; all
     shards of 4 stripes of /a and /b against encode_np and crc32c_py;
     every CRC the engines hold against crc32c_many over its bytes. The
     same sequence at 4 stripes (and 4 CR chunks) on the card and on the
     CPU must give identical records (reads, stored chunks with versions
     and CRCs, routing versions and target states, file lengths); after
     phase 15 it runs again under torch.profiler for each request's device
     share;
 12. the KV-cache serving tier (kv_run): Llama-3.1-8B KV pages
     (32, 2, 8, 16, 128) float16 drawn on the card, session A of 256
     blocks, B of 192 shared + 64, two FleetKVCache members over phase 11's
     RS(12,4) fabric with a loopback peer client; every block that lands
     on the card held bit for bit against its source there; the sequence
     at 8 blocks on the card and on the CPU must give equal records; after
     phase 15 the full run again under torch.profiler;
 13. checkpoints and training data loading (train_run): one Llama-3.1-8B
     decoder layer in float32 (9 leaves, 872,448,000 B) drawn on the card
     through tpu3fs_torch.ckpt on phase 11's RS(12,4) fabric: a sync save,
     a verified and a byte-range restore onto templates on the card (every
     leaf bit-equal to its source there), an async save (its stall, then
     its commit), the first node failed and step 2 restored degraded (K1
     decodes), an empty-disk restart and resync_all, keep-last-1
     retention; then 4,096 records of 8,192 int32 tokens packed into 4
     record files (RecordFileWriter, streaming) and one shuffled,
     CRC-verified epoch (global batch 64, depth 2) of DTensor batches on a
     one-rank NCCL (dp, chain) mesh, every batch's local tensor held
     against its records on the card, and the epoch again cut at step 24,
     its state saved and resumed: the exact remaining batches. The same
     sequence at 2 leaves of 1 MiB and 64 records on the card and on the
     CPU must give equal records (manifests, stored chunks and CRCs, batch
     ids and bytes, the saved state); after phase 15 the full-size save,
     verified restore, packing and epoch again under torch.profiler;
 14. chain-table placement through entry.gen_chain_table: the 180-node CR
     table (width 3, 96 targets per node: b = 5760 chains, 128 proposals a
     step, 200 steps, the CLI's default) and the EC(12,4) table (16 targets
     per node, 18 racks of 10 nodes, at most 4 members of a chain per rack,
     200 steps), each checked by check_solution and equal, line for line,
     to the same seed's run through the full-Gram route (proposals
     materialised on the host, copied in and scored by score_batch), whose
     first 20 steps also hold the swap kernel's scores against the full-Gram
     kernel's; the card's state (M, G, hist, counts, scores) against a fresh
     build from the final table; steps, λ against its lower bound, and one
     CR step's split (draws, copy in, swap kernel, copy back, apply) beside
     the full-Gram route's (proposals, copy in, score_batch, copy back);
 15. times with CUDA events at the main path's shapes, the earlier kernel
     (or the plain version) and the new one in turns, beside each kernel's
     bound and its plain version's time (K4 at every shape of FOLD_SHAPES,
     from CUDA graphs and eagerly, and a torch.profiler trace of a graph
     of K4 calls: the new kernel must be one kernel a call, no memset); the
     times of the hop ops and the one-rank chain step;
 16. concurrent fetch, readahead and the trace sink (fetch_run; run after
     phase 15, whose K4 graph trace once lost a kernel record with phase
     16 run just before it; its launches are added to the kernels line):
     phase 13's records on a fresh RS(12,4) fabric at phase 11's
     shape, one shuffled, CRC-verified epoch of DTensor batches at depth 4
     with 1, 2 and 4 fetch workers in turns (1, 2, 4, 4, 2, 1), each the
     same (epoch, step, ids) and each batch held against its records on
     the card (the K2 launches on the dataload-fetch threads); with the
     span log (sample rate 1) and a StructuredTraceLog on every storage
     service, the epoch at 4 workers again and a 64 MiB file written at 1
     MiB stripes: one dataload.fetch trace a batch, every stripe in the
     StorageEventTrace rows; CheckWorker (no target offlined) and
     DumpWorker (its chunk records equal to the stored chunks) on every
     node, the meta scan's inodes equal to the MetaStore's tree; the file
     read in 1 MiB reads with readahead off and on, healthy and with the
     first node failed (K1 decodes, on the prefetch threads with
     readahead), every byte checked, readahead hits above 0; no fetch,
     readahead or fan-out worker alive after each close; logs in a
     temporary directory. The same sequence at TRAIN_SMALL's records and
     a 4 MiB file on the card and on the CPU must give equal records;
     after phase 15 the epoch at 4 workers again under torch.profiler;
 17. the services over sockets (sockets; after phase 16, its launches
     added to the kernels line under "sockets"; every messenger and child
     pinned to sockets, TPU3FS_USRBIO=0 and usrbio=0): (a) mgmtd, four storage
     apps (engine=mem, usrbio=0) and a meta app in this process on
     run_background over loopback TCP, all on the card, the chains
     uploaded through MgmtdAdminRpcClient (two RS(12,4) chains of 16
     targets, 4 on each node; a CR chain of 3); a warm-up pass at 8 stripes, then
     phase 11's requests through MetaRpcClient, StorageClient and
     RpcMessenger: write /a (48 stripes of 1 MiB), read, a 5,000-byte
     overwrite, stop a node and read degraded, write while it is down,
     an empty node back and the EC rebuild until every chain serves, a
     chain-encoded /b, every stored shard read back and held against its
     twin encoded on the card (4 stripes a file against encode_np and
     crc32c_py), two files removed and collected by meta's GC, 64 chunks
     of 256 KiB on the CR chain; (b) the same services each as its own
     process (python -m tpu3fs_torch.bin.<name>_main --device cuda; the
     storage processes on the JAX package's default engine, auto: the C++
     engine, each on its own data dir under _smoke_run, emptied before a
     restart, a replaced disk), the same requests with a SIGKILL as the
     failure and a new process as the restart, the storage processes
     that launched a kernel (on the C++ engine only decodes and
     chain-encode hops do) shown on the card (a CUDA context and the
     mapped kernel library, read before a SIGKILL for a killed one;
     nvidia-smi's count where it sees another pid namespace), then
     phase 16's records, epochs at 1,
     2 and 4 workers and 1 MiB reads with readahead off and on,
     healthy and with a second process killed; every child stopped by
     SIGTERM within 10 s, exit codes and logs checked. Host ms and
     launches of each request; write, read, degraded-read and rebuild
     MiB/s. (b) counts the client's launches only.
 18. the deployment as processes (fleet; after phase 17, its launches
     under "fleet"): a kvd group of three (kv_main --peers, fsync on),
     monitor_main, mgmtd and two meta servers on --kv the group with 4
     meta partitions, phase 17's four storage nodes and two serving_main
     processes (1 GiB host tiers), each python -m ... --device cuda, the
     storage and serving processes on the JAX package's defaults (hosting
     USRBIO rings; the serving processes' peers over rings, an iov that
     holds a 16-page reply); the script is the inference host (a
     PrefixBlockStore over a FleetKVCache on the card, its peers reached
     by a ServingPeerClient over rings) at phase 12's Llama-3.1-8B pages:
     61's write-through servingLoad put leg, the host's put of A, 61's
     storage fills of A, B's 192-page prefix peer-filled from 61 in
     16-page peerReads and put on the card by get_blocks, in 2 rotated
     turns over the ring peer client and a socket-only one (every
     peerRead of a turn on its transport), B's own pages put from the
     host, single-flight (K
     concurrent misses, one storage fill) and A's fills in 62, a
     storage process SIGKILLed and B's tail read degraded, the kvd leader
     SIGKILLed with meta creates and stats on every partition going on
     and its restart catching up, and aggQuery/sloStatus on the
     collector. Every page on the card and a sample of stored shards
     checked; the storage and serving processes that launched a kernel
     shown on the card, the kvd members and the collector off it; host ms and launches of each
     step, put, peer-fill and storage-fill GiB/s, the prefix-on-card ms
     and the failover's time to the first meta reply. Only the script's
     launches are counted. No ring segment or semaphore is left in
     /dev/shm after it;
 19. the USRBIO rings (rings; after phase 18, its launches under
     "rings"): phase 17 (b)'s cluster as processes (the C++ engine on
     disk, as in 17 (b) and 18) with the storage
     processes on usrbio=1 (their own messengers ride rings to each
     other) and a monitor_main they push their samples to; a ring client
     (TPU3FS_USRBIO=1) and a socket client (0) over the same processes,
     every request on both in one turn (ring first), ring/socket
     ratios: usrbio_bench's batch_write and batch_read of 32 x 1 MiB on
     the CR chain and 32 single write_chunk and read_chunk calls; phase
     17's /a (48 RS(12,4) stripes of 1 MiB) written and read, a storage
     process SIGKILLed and every file read degraded (K1 decodes), a new
     process rebuilt by the storage processes over their rings, a sample
     of stored shards held against twins encoded on the card; each
     storage process's usrbio.completed and usrbio.bytes (via the
     collector) against the ring client's counts, a window a node;
     phase 16's loader at 1, 2 and 4 fetch workers (2 of phase 13's 4
     record files); the hf3fs_usrbio API
     (a UsrbioAgent in the script over each client, a UsrbioClient on
     it): a 128 MiB file (cut from 1 GiB: RING_API_MIB) written and read
     in 1 MiB blocks at depth 32 in 1 turn on each client, then
     read with a second storage process killed, every block checked.
     Every data-plane call of the ring client rides a ring and every call
     of the socket client a socket; the storage processes that launched
     a kernel are shown on
     the card; every child stops on SIGTERM within 10 s with no
     traceback; no tpu3fs-iov-, tpu3fs-ior-, handshake segment or named
     semaphore that the phase's processes mapped or named is left in
     /dev/shm (the SIGKILLed processes' leftovers are reaped first;
     nothing else in the machine's /dev/shm is touched);
 20. the native paths (native; after phase 19, its launches under
     "native"): phase 17 (b)'s cluster with every service on --rpc
     native (the C++ transport), the storage processes on engine=native
     (the C++ engine, data dirs under _smoke_run) and usrbio=0, pushing
     their fast-path, resync and rebuild counters to a monitor_main; a
     StubFactory("native") client and a Python-transport one over the
     same processes: usrbio_bench's 32 x 1 MiB on the CR chain in 2
     rotated turns (medians, native/python ratios; every native turn's
     window shows reads and head writes the C workers served); /a (48
     RS(12,4) stripes) written and read, a storage process SIGKILLed,
     /a read degraded (K1 decodes of 4 lost shards), 4 stripes and 8 CR
     chunks written while it is down, a new process started on the
     killed one's data dir as it was left (the punch-hole compaction
     parked, so its WALs hold all it committed): the time until its
     targets serve, the resync must move exactly the 16 shards and 8 CR
     chunks written while it was down, and the new process must serve
     every chunk committed before the kill as it was (its replay);
     every file read back; every chunk each engine holds fetched by
     target-addressed batch reads and its engine CRC held against
     crc32c_many (K2) on the card; after the processes stop, where
     io_uring is allowed, every target dir read through the io_uring and
     the pread paths, chunk for chunk equal. Every target of every storage process (17
     (b)-20) must be on the C++ engine (the processes' logs name each
     target's engine), and the data dirs are gone after each phase.
 21. the operator's entry points (operator; on phase 20's processes,
     its launches under "operator"): a FUSE mount and usrbio_loadgen
     through it, the admin CLI and the GC and pack tools, the migration
     service (``--operator`` runs the build, phase 20's processes and
     it alone);
 22. the chaos search, the scale fabric and simple_example (chaos_scale;
     after phase 21, the two legs' launches under "chaos" and "scale"):
     (a) the six corpus files of tests/chaos_seeds/ through replay_seed
     on the card, each clean (every checker green, the file's expect
     checkers passed, so its sidecar ran) and with its bug armed (its
     expect checkers violated); search_violations over
     tests/test_chaos.py's SMALL spec at seeds 100-102, green; with
     commit_skip armed from seed 0 within 16 seeds, found, shrunk by
     shrink_schedule to a minimal prefix that violates armed and not
     disarmed; three corpus schedules through FabricRunner, every oracle
     CRC taken on the card (K2) held against crc32c_py; one line a run:
     wall seconds, events applied and skipped, checker statuses, K1, K2
     and K3 launches; (b) ScaleFabric(ScaleConfig(num_nodes=1000,
     num_domains=10), device): boot, a heartbeat round (mean and p99 us),
     the tick sweep, the routing fan-out cold (polled by 100 nodes of a
     100-node fabric, cut from 1,000 for the time limit; all 1,000 with
     --chaos) and warm (bytes, seconds),
     the KV bounded over 3 more rounds, a whole-domain kill breaking no
     chain, restart and resync; the domain-blind A/B at 30 nodes in 3
     domains (blind must break chains); plan_rebalance at 10,000 chains;
     the SLO aggregation at 1,000 series; (c) python -m
     tpu3fs_torch.simple_example.service --device cuda answers a write
     and a read over the port's RpcClient and exits 0 on SIGTERM.
 23. the ICI chain transport and the EC mesh rebuild (mesh; after phase
     22, the legs' launches under "ici" and "mesh_rebuild") and the
     multi-rank save (on phase 20's processes after phase 21, its
     launches under "mesh_save"): (a) an in-process Fabric(cfg, device)
     with chain_transport="ici" on make_storage_mesh(3, devices=[cuda] *
     3), two CR chains of 3 on one node: 64 chunks of 1 MiB in one
     batch_write and 32 partial overwrites, replies and committed state
     (bytes, versions, CRCs a target) equal to a messenger fabric's on
     the same writes, an ICI hit on every batch, K4 (the hop's
     cross-check) and K2 (the successors' installs) launched; a mesh
     whose chain axis (2) differs from the chains' width falls back on
     every batch; write MiB/s of both transports in turns; (b) RS(12,4)
     at phase 11's shape (48 stripes of 1 MiB, 4 nodes, 2 chains) and
     RS(3,1) (16 stripes): the first node failed, its engines emptied,
     the node back and resync_all(mesh=make_storage_mesh(k + m,
     devices=[cuda] * (k + m))): every rebuilt chunk equal to its
     original and the stored state to a meshless resync's, K1 launched
     at RS(12,4), K3 at RS(3,1); rebuild MiB/s of both routes; (c) 4 rank
     processes on a gloo group (cuda DTensors on a (2, 2) cuda mesh)
     save phase 13's Llama-3.1-8B decoder layer through the C++
     transport, rank 0 commits; each rank's K2 launches pushed to the
     collector; the manifest's boxes and CRCs checked and a verified
     restore in the script equal to the layer byte for byte.
Phases 7-14, 16-21, 22 (a) and (b) and 23 are the main path: every kernel count is set to 0
just before each and read just after; every K1 and K2 launch there must be a
tensor-core one and every K1-K5 call a kernel launch, none a plain version
(K4 on the main path is the one-launch kernel, never the atomic one; K5
the swap scorer; the full-Gram score_batch is its check).
``python3 chip_smoke.py --fold-variants`` instead builds the kernels and
times K4's launch plan varied (fold_variants); ``--kvcache`` builds them
and runs phase 12 alone, with its traced run; ``--ckpt`` builds them and
runs phase 13 alone, with its traced run; ``--fetch`` builds them and
runs phase 16 alone, with its traced run; ``--sockets`` builds them and
runs phase 17 alone; ``--fleet`` builds them and runs phase 18 alone;
``--rings`` builds them and runs phase 19 alone; ``--native`` builds them
and runs phase 20 alone; ``--chaos`` builds them and runs phase 22 alone;
``--mesh`` builds them and runs phase 23: (a), (b), then (c) on phase
20's processes (booted for it, without phase 20's own requests).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import re
import socket
import struct
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

MIB = 1 << 20
# H100 SXM published peaks (dense): HBM3 bandwidth and int8 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
K, M, S_WRITE, B_WRITE = 12, 4, MIB, 12   # bench.py's RS(12,4) write batch
CHUNK_BYTES, S_CHUNK = 4 * MIB, 349_696    # shard_size_of(4 MiB, 12)
# K4's shapes: (B, S, base offset, why)
FOLD_SHAPES = [(B_WRITE, S_WRITE, 0, "the chain write batch"),
               (2, 128, 0, "the dry run's launches"),
               (K, S_CHUNK, 0, "one 4 MiB chunk's shards"),
               (1, 64 * MIB, 0, "one long row"),
               (64, 64 * 1024, 0, "an ICI bucket of medium writes"),
               (1024, 4096, 0, "an ICI bucket of small writes"),
               (B_WRITE, S_WRITE + 3, 1, "ragged S, unaligned base")]
STORE_STRIPES = 64                         # 64 x 16 x 1 MiB = 1 GiB store
NO_LIBRARY = ("no single PyTorch call computes a GF(2^8) matrix apply "
              "or a CRC32C")
NO_XOR_LIBRARY = ("torch has no XOR reduction: no single PyTorch call "
                  "computes the XOR of k rows")
NO_FOLD_LIBRARY = ("torch has no XOR reduction: no single PyTorch call "
                   "computes the XOR fold of a row's words")
NO_SCORE_LIBRARY = ("no single PyTorch call computes the fused score: the "
                    "Gram's off-diagonal max and sum of squares and the "
                    "domain overflow")
NO_SWAP_LIBRARY = ("no single PyTorch call computes a proposal's scores "
                   "from its swap (gathers of two rows of M and of G, "
                   "histogram tests, the overflow of four counts)")
NO_APPLY_LIBRARY = ("no single PyTorch call applies a swap to the table, its "
                    "Gram, the Gram's histogram, the counts and the scores")
# the reference deployment's storage cluster: 180 nodes x 16 SSDs, CR width
# 3 at 6 targets per disk (96 per node); EC(12,4) at one target per disk
# over 18 racks of 10 nodes, at most ec_m members of a chain per rack
PLACE_NODES, CR_WIDTH, CR_TARGETS, PLACE_STEPS = 180, 3, 96, 200
CHECKED_STEPS = 20  # steps whose swap scores are held against score_batch
EC_K, EC_M, EC_TARGETS, RACKS = 12, 4, 16, 18
OUT_DIR = Path("chiprun_out")  # traces and sweeps, git-ignored


def log(*parts) -> None:
    print(*parts, flush=True)


def require(ok, what: str) -> None:
    """A failed check ends the run with a nonzero exit."""
    if not ok:
        raise AssertionError(what)


def phase(name: str):
    log(f"== {name}")
    return time.perf_counter()


def rand_u8(shape, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                         generator=g)


def as_i64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.uint32:  # few kernels take uint32: go through int32
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


class Compare:
    """Holds a kernel's results against a reference; keeps the worst error."""

    def __init__(self):
        self.max_abs_err = 0
        self.cases = 0

    def __call__(self, got: torch.Tensor, want: torch.Tensor, label: str):
        if got.shape != want.shape:
            raise AssertionError(f"{label}: shape {got.shape} vs {want.shape}")
        err = int((as_i64(got) - as_i64(want)).abs().max()) if got.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        self.cases += 1
        if err:
            raise AssertionError(f"{label}: kernel differs from reference "
                                 f"(max abs err {err})")


def cuda_ms(fn, iters: int, warm: int = 2) -> float:
    """Mean device time of fn() over iters calls, with CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls captured in one CUDA graph
    and replayed: without the host's enqueue time, which hides a kernel of
    a few microseconds from cuda_ms."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, int8_ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counters() -> dict:
    """name -> (function, attribute) of every kernel wrapper's launch count,
    and of the call counts of the kernels' plain versions
    (``kernels.COUNTERS``)."""
    from tpu3fs_torch import kernels

    return kernels.counter_objects()


def read_counts() -> dict:
    return {n: getattr(f, a) for n, (f, a) in counters().items()}


def zero_counts() -> None:
    for f, a in counters().values():
        setattr(f, a, 0)


def require_main_path(path: str, counts: dict, launched) -> None:
    """Every kernel in ``launched`` ran in this path; no K1 or K2 launch
    took the earlier integer-unit kernels, no K4 launch the atomic kernel and
    no call went to a kernel's plain version."""
    for name in launched:
        require(counts[name] > 0, f"{name} was not launched on {path}")
    for name in ("gf2_matmul_bitslice", "crc32c_blocks_table",
                 "gf2_matmul_plain", "crc32c_plain",
                 "xor_reduce_plain", "xor_fold_crc_plain",
                 "xor_fold_crc_atomic", "score_batch_plain",
                 "swap_score_plain", "swap_apply_plain"):
        require(counts[name] == 0,
                f"{name} ran on {path}: every K1 and K2 launch there must "
                "be a tensor-core launch and every K1-K5 call a launch of "
                "its new kernel")


# -- phase 1 -----------------------------------------------------------------
def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() or f"nvidia-smi: {smi.stderr.strip()}"


def environment() -> str:
    phase("phase 1: environment")
    log(card_line())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a card")
    # the plain versions take 0/1 products in float32; keep them full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind} count {torch.cuda.device_count()}")
    return kind


def host_line() -> str:
    """Whether /dev/fuse exists and opens, g++'s version, the filesystem
    of the run dir, where the storage processes keep their data dirs,
    with the read path a native engine takes there, and what the mount
    of phase 21 needs (``fuse_host``: libfuse.so.2, fusermount, the
    uid)."""
    from tpu3fs_torch import hostbuild
    from tpu3fs_torch.storage.native_engine import FS_TYPES, fs_type, read_path

    fuse = "/dev/fuse absent"
    if os.path.exists("/dev/fuse"):
        try:
            os.close(os.open("/dev/fuse", os.O_RDWR))
            fuse = "/dev/fuse present and openable"
        except OSError as e:
            fuse = f"/dev/fuse present, not openable ({e.strerror})"
    try:
        gxx = subprocess.run([hostbuild.compiler(), "--version"],
                             capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0]
    except (RuntimeError, OSError, IndexError) as e:
        gxx = f"no g++ ({e})"
    import tempfile

    RUN_DIR.mkdir(exist_ok=True)
    kinds = {}
    for d in (RUN_DIR, tempfile.gettempdir(), "/"):
        t = fs_type(str(d))
        kinds[str(d)] = FS_TYPES.get(t, hex(t))
    return (f"{fuse}; {gxx}; filesystems {kinds} (the run dir first), "
            f"native engine read path {read_path(str(RUN_DIR))}; "
            f"for the mount {json.dumps(fuse_host())}")


# -- phase 2 -----------------------------------------------------------------
def build() -> None:
    from tpu3fs_torch import hostbuild, kernels

    t0 = phase("phase 2: build")
    # g++ (the host libraries and the loadgen) beside nvcc (the kernels)
    host = threading.Thread(target=lambda: [
        *(hostbuild.load(n) for n in hostbuild.SOURCES),
        *(hostbuild.executable(n) for n in hostbuild.PROGRAMS)])
    host.start()
    kernels.library()
    log(f"kernel library built and loaded in {time.perf_counter() - t0:.2f} s")
    host.join()
    for n in hostbuild.SOURCES:
        require(n in hostbuild._loaded, f"the host library {n} did not load")
    for n in hostbuild.PROGRAMS:
        require(hostbuild.library_path(n).exists(),
                f"the host program {n} was not built")
    log(f"host libraries {[hostbuild.library_path(n).name for n in hostbuild.SOURCES]}"
        f" and programs {[hostbuild.library_path(n).name for n in hostbuild.PROGRAMS]}"
        f" built in {time.perf_counter() - t0:.2f} s")
    for line in kernels.build_log().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            log("  ptxas:", line.strip())


# -- phase 3 -----------------------------------------------------------------
def check_k1(dev, cmp: Compare) -> None:
    from tpu3fs_torch.ops.gf256 import GF
    from tpu3fs_torch.ops.gf2_matmul import (gf2_matmul, gf2_matmul_bitslice,
                                             gf2_matmul_plain, prepare_matrix)
    from tpu3fs_torch.ops.rs import RSCode

    t0 = phase("phase 3: K1 gf2_matmul (both kernels) against its plain version")

    def both(cols, data, label, tensor_core=True):
        """gf2_matmul (the tensor-core kernel where it takes the shape) and
        the bit-sliced kernel, each against the plain version."""
        n_tc, n_bs = gf2_matmul.launches, gf2_matmul_bitslice.launches
        got = gf2_matmul(cols, data)
        want = gf2_matmul_plain(cols, data)
        cmp(got, want, label)
        cmp(gf2_matmul_bitslice(cols, data), want, label + " (bit-sliced)")
        require(gf2_matmul.launches - n_tc == int(tensor_core) and
                gf2_matmul_bitslice.launches - n_bs == 2 - int(tensor_core),
                f"{label}: launched the wrong K1 kernel")
        return got

    # layout probes first: a unit matrix copies the data; one set bit of one
    # symbol at a time lights exactly the matrix column of that bit
    eye = prepare_matrix(GF.expand_to_bits(np.eye(K, dtype=np.uint8)), dev)
    probe_data = rand_u8((2, K, 4096), 21, dev)
    cmp(both(eye, probe_data, "probe: unit matrix"), probe_data,
        "probe: unit matrix copies")
    rs = RSCode(K, M, device=dev)
    single = torch.zeros((1, K, 8 * K * 16), dtype=torch.uint8, device=dev)
    for j in range(K):
        for t in range(8):
            single[0, j, 16 * (8 * j + t)] = 1 << t
    got = both(rs._parity_cols, single, "probe: single bits")
    want = rs._parity_cols.reshape(M, 8 * K)  # column 8j + t
    cmp(got[0, :, ::16], want, "probe: single bits light their columns")

    for S in (S_WRITE, S_CHUNK):
        data = rand_u8((B_WRITE, K, S), 1, dev)
        parity = both(rs._parity_cols, data, f"encode RS(12,4) S={S}")
        gold = rs.encode_np(data[:2].cpu().numpy())
        cmp(parity[:2].cpu(), torch.from_numpy(gold), f"encode gold S={S}")
    shards = torch.cat([data, parity], dim=1)
    for lost in [(0,), (0, 5), (0, 5, 12), (0, 5, 12, 15)]:
        present = [i for i in range(K + M) if i not in lost][:K]
        R = rs._reconstruct_matrix(tuple(present), lost)
        cols = prepare_matrix(GF.expand_to_bits(R), dev)
        out = both(cols, shards[:, present].contiguous(), f"decode o={len(lost)}")
        cmp(out, shards[:, list(lost)], f"decode o={len(lost)} restores")
        gold = rs.reconstruct_np(present, lost, shards[:1, present].cpu().numpy())
        cmp(out[:1].cpu(), torch.from_numpy(gold), f"decode gold o={len(lost)}")
    for k, m, S, B in [(3, 1, S_WRITE, 2), (6, 3, S_WRITE, 2),
                       (240, 16, 4096, 2), (255, 1, 4096, 2), (40, 6, 4160, 3)]:
        code = RSCode(k, m, device=dev)
        both(code._parity_cols, rand_u8((B, k, S), k, dev), f"RS({k},{m}) S={S}")
    # a ragged S and a base that is not 16-byte aligned: the bit-sliced kernel
    both(rs._parity_cols, rand_u8((3, K, 1000), 12, dev), "RS(12,4) S=1000",
         tensor_core=False)
    flat = rand_u8((2 * K * 4096 + 1,), 7, dev)
    both(rs._parity_cols, flat[1:].view(2, K, 4096), "unaligned base",
         tensor_core=False)
    # zero-size work returns without a launch
    n0 = gf2_matmul.launches + gf2_matmul_bitslice.launches
    empty_o = RSCode(4, 0, device=dev).encode(rand_u8((2, 4, 64), 3, dev))
    empty_b = rs.encode(rand_u8((0, K, 64), 3, dev))
    require(empty_o.shape == (2, 0, 64) and empty_b.shape == (0, M, 64)
            and gf2_matmul.launches + gf2_matmul_bitslice.launches == n0,
            "a zero-size call launched")
    torch.cuda.synchronize()
    log(f"K1: {cmp.cases} comparisons equal ({time.perf_counter() - t0:.1f} s)")


# -- phase 4 -----------------------------------------------------------------
def check_k2(dev, cmp: Compare) -> None:
    from tpu3fs_torch.ops.crc32c import (BatchCrc32c, crc32c_blocks,
                                         crc32c_blocks_table, crc32c_py)

    t0 = phase("phase 4: K2 crc32c_blocks (both kernels) against its plain version")

    def both(bc, x, label, tensor_core=True):
        """The codec's kernel (tensor cores where it takes the shape) and the
        table kernel, each against the plain version."""
        n_tc, n_tb = crc32c_blocks.launches, crc32c_blocks_table.launches
        got = bc(x)
        want = bc.compute(x)
        cmp(got, want, label)
        cmp(crc32c_blocks_table(x, bc._ks_cols, bc.block, bc._const), want,
            label + " (table)")
        require(crc32c_blocks.launches - n_tc == int(tensor_core) and
                crc32c_blocks_table.launches - n_tb == 2 - int(tensor_core),
                f"{label}: launched the wrong K2 kernel")
        return got

    # layout probe first: one set bit at each bit offset of a block
    for block in (512, 192, 64):
        bc = BatchCrc32c(block, block, device=dev)
        off = torch.arange(8 * block, device=dev)
        x = torch.zeros((8 * block, block), dtype=torch.uint8, device=dev)
        x[off, off // 8] = (1 << (off % 8)).to(torch.uint8)
        got = both(bc, x, f"probe: single bits, block {block}")
        gold = torch.tensor([crc32c_py(r.tobytes()) for r in x.cpu().numpy()],
                            dtype=torch.int64)
        cmp(as_i64(got).cpu(), gold, f"probe gold, block {block}")

    for size, block, rows, tensor_core in [
            (S_WRITE, 512, B_WRITE * (K + M), True), (S_CHUNK, 512, K + M, True),
            (4096, 512, 64, True), (192, 192, 64, True), (64, 64, 33, True),
            (1000, 1000, 8, False)]:
        bc = BatchCrc32c(size, block, device=dev)
        x = rand_u8((rows, size), size, dev)
        x[1] = 0
        x[2] = 0xFF
        got = both(bc, x, f"crc size={size} block={block}", tensor_core)
        checked = [0, 1, 2] if size <= S_CHUNK else [0]
        host = x[checked].cpu().numpy()
        gold = torch.tensor([crc32c_py(r.tobytes()) for r in host],
                            dtype=torch.int64)
        cmp(as_i64(got)[checked].cpu(), gold, f"crc gold size={size}")
    # a base that is not 16-byte aligned: the table kernel
    bc = BatchCrc32c(4096, 512, device=dev)
    flat = rand_u8((16 * 4096 + 1,), 8, dev)
    both(bc, flat[1:].view(16, 4096), "unaligned base", tensor_core=False)
    n_tb = crc32c_blocks_table.launches
    vec = BatchCrc32c(9, 9, device=dev)(
        torch.frombuffer(bytearray(b"123456789"), dtype=torch.uint8)
        .reshape(1, 9).to(dev))
    require(int(as_i64(vec)[0]) == 0xE3069283, "crc32c(b'123456789')")
    require(crc32c_blocks_table.launches == n_tb + 1,
            "the 9-byte row did not take the table kernel")
    torch.cuda.synchronize()
    log(f"K2: {cmp.cases} comparisons equal ({time.perf_counter() - t0:.1f} s)")


# -- phase 5 -----------------------------------------------------------------
def check_k3(dev, cmp: Compare) -> None:
    from tpu3fs_torch.ops.xor_reduce import xor_reduce, xor_reduce_plain

    t0 = phase("phase 5: K3 xor_reduce against its plain version")

    def check(x, label):
        n = xor_reduce.launches
        got = xor_reduce(x)
        require(xor_reduce.launches == n + 1, f"{label}: K3 did not launch")
        cmp(got, xor_reduce_plain(x), label)
        return got

    # layout probe first: one set byte per row lands in its own column
    probe = torch.zeros((2, K, 16 * K), dtype=torch.uint8, device=dev)
    for j in range(K):
        probe[:, j, 16 * j + j % 16] = 1 << (j % 8)
    want = torch.zeros((2, 1, 16 * K), dtype=torch.uint8, device=dev)
    for j in range(K):
        want[:, 0, 16 * j + j % 16] = 1 << (j % 8)
    cmp(check(probe, "probe: one byte per row"), want, "probe lands")

    for k in (2, 7, K):
        check(rand_u8((B_WRITE, k, S_WRITE), 30 + k, dev), f"k={k} S=1 MiB")
    check(rand_u8((3, K, S_CHUNK), 41, dev), f"k=12 S={S_CHUNK}")
    check(rand_u8((3, K, 1000), 42, dev), "ragged S=1000")
    flat = rand_u8((2 * K * 4096 + 1,), 43, dev)
    check(flat[1:].view(2, K, 4096), "unaligned base")
    check(rand_u8((K, 4096), 44, dev), "no batch dimension")
    n0 = xor_reduce.launches
    empty = xor_reduce(rand_u8((0, K, 64), 45, dev))
    require(empty.shape == (0, 1, 64) and xor_reduce.launches == n0,
            "a zero-size call launched")
    torch.cuda.synchronize()
    log(f"K3: {cmp.cases} comparisons equal ({time.perf_counter() - t0:.1f} s)")


# -- phase 6 -----------------------------------------------------------------
def fold_input(shape, offset: int, seed: int, dev) -> torch.Tensor:
    """A (B, S) uint8 view ``offset`` bytes into a fresh allocation (the
    allocator's 512-byte alignment plus ``offset``)."""
    batch, size = shape
    flat = rand_u8((batch * size + offset,), seed, dev)
    return flat[offset:].view(batch, size)


def check_k4(dev, cmp4: Compare) -> None:
    """K4 against its plain version and the atomic kernel: byte probes, the
    timing table's shapes at base offsets 0-15, eagerly and from graph
    replays on fresh inputs."""
    from tpu3fs_torch.ops.xor_fold import (xor_fold_crc, xor_fold_crc_atomic,
                                           xor_fold_crc_plain)

    t0 = phase("phase 6: K4 xor_fold_crc against its plain version and "
               "the atomic kernel (xor_fold_crc_atomic)")

    def fold(x, label, launched=True):
        n = xor_fold_crc.launches
        got = xor_fold_crc(x)
        require(xor_fold_crc.launches == n + int(launched),
                f"{label}: K4 launched {xor_fold_crc.launches - n} times")
        cmp4(got, xor_fold_crc_plain(x), label)
        return got

    # layout probe first: byte r of row r lands in byte r % 4 of the fold,
    # in the row's head, body or tail, whatever the base's alignment
    for size in (64, 67):
        for base in (0, 1, 2, 3, 7):
            flat = torch.zeros(size * size + base, dtype=torch.uint8, device=dev)
            x = flat[base:].view(size, size)
            r = torch.arange(size, device=dev)
            x[r, r] = (1 << (r % 8)).to(torch.uint8)
            want = (1 << (r % 8)) << (8 * (r % 4))
            cmp4(as_i64(fold(x, f"probe S={size} base+{base}")), want,
                 f"probe S={size} base+{base} lands")
    for size in (4096, 4097, 4098, 4099, 7, 1000):
        fold(rand_u8((5, size), 60 + size % 97, dev), f"B=5 S={size}")
    fold(rand_u8((3, 0), 65, dev), "S=0", launched=False)
    fold(rand_u8((0, 64), 66, dev), "B=0", launched=False)
    # the timing table's shapes at every base offset: equal to the plain
    # version and to the atomic kernel
    for (batch, size, _, why), seed in zip(FOLD_SHAPES, itertools.count(70)):
        for offset in range(16):
            x = fold_input((batch, size), offset, seed + 100 * offset, dev)
            label = f"{batch} x {size} +{offset} ({why})"
            got = fold(x, label)
            cmp4(got, xor_fold_crc_atomic(x), f"{label}: atomic kernel")
    torch.cuda.synchronize()
    # one call captured in a CUDA graph, replayed three times on fresh
    # inputs copied into the captured buffer
    for (batch, size, offset, why), seed in zip(FOLD_SHAPES, itertools.count(200)):
        for base in sorted({0, offset, 3}):
            static = fold_input((batch, size), base, seed, dev)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                xor_fold_crc(static)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = xor_fold_crc(static)
            for rep in range(3):
                static.copy_(rand_u8((batch, size), seed + 1000 + rep, dev))
                graph.replay()
                cmp4(out, xor_fold_crc_plain(static),
                     f"{batch} x {size} +{base} graph replay {rep}")
    torch.cuda.synchronize()
    log(f"K4: {cmp4.cases} comparisons equal "
        f"({time.perf_counter() - t0:.1f} s)")


def check_k5(dev, cmp5: Compare) -> None:
    from tpu3fs_torch.ops.placement_score import score_batch, score_batch_plain

    t0 = phase("phase 6: K5 score_batch against its plain version")

    def score(Ms, label, dom=None, cap=2, launched=True):
        n = score_batch.launches
        got = score_batch(Ms, dom, cap)
        require(score_batch.launches == n + int(launched),
                f"{label}: K5 launched {score_batch.launches - n} times")
        for part, g, w in zip(("overflow", "max", "ssq"), got,
                              score_batch_plain(Ms, dom, cap)):
            cmp5(g, w, f"{label} {part}")
        return got

    def incidences(P, b, v, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.rand((P, b, v), device=dev, generator=g) < 0.4).to(
            torch.int8)

    # layout probe first: proposal q holds one group with nodes i_q and j_q,
    # in the same Gram tile, in neighbouring tiles and in the farthest ones
    pairs = [(0, 1), (63, 64), (0, 179), (127, 128), (100, 150)]
    probe = torch.zeros((len(pairs), 1, 180), dtype=torch.int8, device=dev)
    for q, (i, j) in enumerate(pairs):
        probe[q, 0, [i, j]] = 1
    _, mx, ssq = score(probe, "probe: one pair per proposal")
    ones = torch.ones(len(pairs), dtype=torch.int32, device=dev)
    cmp5(mx, ones, "probe max")
    cmp5(ssq, 2 * ones, "probe ssq")
    for v in (1, 7, 13, 180):
        for b in (2, 37, 5760):
            for P in (1, 3, 128):
                Ms = incidences(P, b, v, v * 7919 + b * 31 + P)
                score(Ms, f"P={P} b={b} v={v}")
                g = torch.Generator(device=dev).manual_seed(v + b + P)
                dom = torch.randint(0, min(v, RACKS), (v,), generator=g,
                                    device=dev, dtype=torch.int32)
                score(Ms, f"P={P} b={b} v={v}, domains", dom)
    g = torch.Generator(device=dev).manual_seed(67)
    signed = torch.randint(-3, 4, (3, 37, 13), generator=g, device=dev,
                           dtype=torch.int8)
    score(signed, "signed values", signed[0, 0].abs().to(torch.int32) % 3)
    flat = incidences(1, 1, 2 * 37 * 180 + 1, 68).reshape(-1)
    score(flat[1:].view(2, 37, 180), "unaligned base")
    for shape in ((0, 37, 13), (3, 0, 13), (3, 37, 0)):
        score(torch.zeros(shape, dtype=torch.int8, device=dev),
              f"zero-size {shape}", launched=False)
    torch.cuda.synchronize()
    log(f"K5: {cmp5.cases} comparisons equal "
        f"({time.perf_counter() - t0:.1f} s)")


def random_table(b: int, v: int, k: int, seed: int) -> np.ndarray:
    """(b, v) int8: each row k distinct nodes drawn from a seed."""
    rng = np.random.default_rng(seed)
    M = np.zeros((b, v), dtype=np.int8)
    M[np.arange(b)[:, None], rng.random((b, v)).argsort(axis=1)[:, :k]] = 1
    return M


def rack_index(v: int, racks: int) -> np.ndarray:
    return (np.arange(v) * racks // v).astype(np.int32)


def moves_on(moves, dev) -> torch.Tensor:
    """A step's moves as the solver sends them: one int32 (5, P) tensor."""
    return torch.from_numpy(np.stack(moves).astype(np.int32)).to(dev)


def state_parts(state) -> dict:
    return {n: getattr(state, n) for n in ("M", "G", "hist", "counts", "score")
            if getattr(state, n) is not None}


def check_k5_swap(dev, cmp_score: Compare, cmp_apply: Compare) -> None:
    """The swap scorer's two kernels against their plain versions; the
    scores also against the full-Gram kernel on the materialised proposals,
    and the applied states against a fresh build from the table."""
    from tpu3fs_torch.ops.placement_score import score_batch
    from tpu3fs_torch.ops.swap_score import (swap_apply, swap_apply_plain,
                                             swap_score, swap_score_plain,
                                             swap_state)
    from tpu3fs_torch.placement import PlacementProblem, solver

    t0 = time.perf_counter()
    log("phase 6: K5's swap scorer (swap_score, swap_apply) against their "
        "plain versions")
    greedy_cr = solver._greedy_incidence(PlacementProblem(
        num_nodes=PLACE_NODES, group_size=CR_WIDTH,
        targets_per_node=CR_TARGETS))
    v = PLACE_NODES
    cases = [  # label, table, domain index, cap
        ("k=3 b=5760", random_table(5760, v, 3, 1), None, 0),
        ("k=3 b=5760, 18 racks", random_table(5760, v, 3, 2),
         rack_index(v, RACKS), 1),
        ("k=3 b=5760, 60 domains", random_table(5760, v, 3, 3),
         rack_index(v, 60), 1),
        ("greedy CR table (max ties)", greedy_cr, None, 0),
        ("k=16 b=180", random_table(180, v, 16, 4), None, 0),
        ("k=16 b=180, 18 racks", random_table(180, v, 16, 5),
         rack_index(v, RACKS), EC_M),
        ("k=16 b=180, 18 racks, cap 1", random_table(180, v, 16, 6),
         rack_index(v, RACKS), 1),
        ("k=16 b=180, 180 domains", random_table(180, v, 16, 7),
         np.arange(v, dtype=np.int32), 1),
        ("k=1 b=180", random_table(180, v, 1, 8), None, 0),
        ("k=1 b=180, 18 racks", random_table(180, v, 1, 9),
         rack_index(v, RACKS), 0),
        ("duplicated rows (invalid moves), 18 racks",
         np.repeat(random_table(6, v, 16, 10), 2, axis=0),
         rack_index(v, RACKS), EC_M),
        ("ssq past 2**31: k=8 v=16 b=20000", random_table(20000, 16, 8, 11),
         None, 0),
    ]
    rng = np.random.default_rng(12)
    for label, M, dom, cap in cases:
        state = swap_state(M, dom, cap, dev)
        dom_t = None if dom is None else torch.from_numpy(dom).to(dev)
        for P in (1, 3, 128):
            moves = solver._propose_moves(M, rng, P)
            mt = moves_on(moves, dev)
            n = swap_score.launches
            got = swap_score(state, mt)
            require(swap_score.launches == n + 1,
                    f"{label} P={P}: the swap kernel did not launch")
            cmp_score(got, swap_score_plain(state, mt), f"{label} P={P}")
            cand = torch.from_numpy(solver._materialise(M, moves)).to(dev)
            cmp_score(got, torch.stack(score_batch(cand, dom_t, cap)),
                      f"{label} P={P}: against the full-Gram kernel")
        if label.startswith("ssq past"):
            require(int(state.score[2]) >= 1 << 31,
                    f"{label}: the state's ssq does not pass 2**31")
    n = swap_score.launches
    empty = swap_score(state, torch.zeros((5, 0), dtype=torch.int32,
                                          device=dev))
    require(empty.shape == (3, 0) and swap_score.launches == n,
            "a zero-size swap score launched")
    torch.cuda.synchronize()
    log(f"K5 swap_score: {cmp_score.cases} comparisons equal")

    for label, M, dom, cap, n_moves in [
            ("k=16 b=180, 18 racks", random_table(180, v, 16, 13),
             rack_index(v, RACKS), EC_M, 500),
            ("k=3 b=5760", random_table(5760, v, 3, 14), None, 0, 100),
            ("ssq past 2**31", random_table(20000, 16, 8, 15), None, 0, 50)]:
        M = M.copy()
        kernel_state = swap_state(M, dom, cap, dev)
        plain_state = swap_state(M, dom, cap, dev)
        n = swap_apply.launches
        for i in range(n_moves):
            moves = solver._propose_moves(M, rng, 8)
            p = int(np.argmax(moves.valid))
            require(moves.valid[p], f"{label}: no valid move drawn")
            mt = moves_on(moves, dev)
            swap_apply(kernel_state, mt, p)
            swap_apply_plain(plain_state, mt, p)
            g1, g2, a, c = (int(x[p]) for x in moves[:4])
            M[g1, a], M[g1, c], M[g2, c], M[g2, a] = 0, 1, 0, 1
            fresh = state_parts(swap_state(M, dom, cap, dev))
            kern, plain = state_parts(kernel_state), state_parts(plain_state)
            for part, want in fresh.items():
                cmp_apply(kern[part], plain[part], f"{label} move {i} {part}")
                cmp_apply(kern[part], want, f"{label} move {i} {part}: fresh")
        require(swap_apply.launches == n + n_moves,
                f"{label}: the apply kernel launched "
                f"{swap_apply.launches - n} times for {n_moves} moves")
    torch.cuda.synchronize()
    log(f"K5 swap_apply: {cmp_apply.cases} comparisons equal "
        f"({time.perf_counter() - t0:.1f} s)")


# -- phase 7 -----------------------------------------------------------------
def serve(dev) -> dict:
    """The stripe server answers requests; returns launch counts per request."""
    from tpu3fs_torch.ops.crc32c import crc32c_py
    from tpu3fs_torch.ops.stripe import StripeCodec, shard_size_of

    t0 = phase("phase 7: the stripe server answers requests")
    codec = StripeCodec(K, M, S_WRITE, device=dev)
    chunk_codec = StripeCodec(K, M, shard_size_of(CHUNK_BYTES, K), device=dev)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (B_WRITE, K, S_WRITE), dtype=np.uint8)
               for _ in range(3)]
    requests = []

    def request(name, fn):
        before = read_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        after = read_counts()
        requests.append({"request": name,
                         "host_ms": (time.perf_counter() - t) * 1e3,
                         **{n: after[n] - before[n] for n in after}})
        return out

    zero_counts()
    written = [request(f"write batch {i}", lambda d=d: codec.encode_batch(d))
               for i, d in enumerate(batches)]
    shards, crcs = written[0]
    n = K + M
    flat = shards.reshape(B_WRITE * n, S_WRITE)
    verified = request("verify 192 shards", lambda: codec.crc_batch(flat))
    bad = flat.copy()
    bad[5 * n + 7, 12345] ^= 0x40
    flagged = request("verify with one corrupt byte",
                      lambda: codec.crc_batch(bad)) != crcs.reshape(-1)
    lost4 = (0, 5, 12, 15)
    present4 = [i for i in range(n) if i not in lost4]
    read4 = request("degraded read, lost {0,5,12,15}",
                    lambda: codec.reconstruct_batch(present4, lost4,
                                                    shards[:, present4]))
    present1 = [i for i in range(K + 1) if i != 3]
    read1 = request("degraded read, lost {3} (XOR)",
                    lambda: codec.reconstruct_batch(present1, (3,),
                                                    shards[:, present1]))

    # rebuild one failed shard index across a 64-stripe, 1 GiB device store
    store = torch.empty((STORE_STRIPES, n, S_WRITE), dtype=torch.uint8,
                        device=dev)
    store_crcs = torch.empty((STORE_STRIPES, n), dtype=torch.int32, device=dev)
    for b0 in range(0, STORE_STRIPES, 16):
        sh, cr = codec.encode_batch(rand_u8((16, K, S_WRITE), 100 + b0, dev))
        store[b0:b0 + 16] = sh
        store_crcs[b0:b0 + 16] = cr.view(torch.int32)
    failed = 7
    survivors = [i for i in range(n) if i not in (failed, K)][:K]

    def rebuild():
        rebuilt = codec.reconstruct_batch(
            survivors, (failed,), store[:, survivors].contiguous())
        return rebuilt, codec.crc_batch(
            rebuilt.reshape(STORE_STRIPES, S_WRITE))
    rebuilt, rebuilt_crcs = request("rebuild shard 7 of a 1 GiB store", rebuild)

    chunk = rng.integers(0, 256, CHUNK_BYTES, dtype=np.uint8).tobytes()
    lostc = (2, 9, 13)

    def chunk_round_trip():
        cs, cc = chunk_codec.encode_stripe(chunk)
        pres = [i for i in range(n) if i not in lostc][:K]
        back = chunk_codec.reconstruct_batch(pres, lostc, cs[None, pres])[0]
        full = cs.copy()
        full[list(lostc)] = back
        again = chunk_codec.crc_batch(full)
        return cs, cc, full, again, chunk_codec.assemble(
            [full[j].tobytes() for j in range(K)], len(chunk))
    cs, cc, full, again, assembled = request("4 MiB chunk write + degraded read",
                                             chunk_round_trip)
    launches = read_counts()

    # answers are right: numpy gold, scalar CRC, restored bytes
    rs = codec.rs
    for d, (sh, _) in zip(batches, written):
        require(np.array_equal(sh[:2, K:], rs.encode_np(d[:2])),
                "write parity differs from the numpy gold")
    require(int(crcs[3, 14]) == crc32c_py(shards[3, 14].tobytes()),
            "stored CRC differs from crc32c_py")
    require(np.array_equal(verified, crcs.reshape(-1)),
            "verify disagrees with the stored CRCs")
    require(np.flatnonzero(flagged).tolist() == [5 * n + 7],
            f"corrupt shard flags {np.flatnonzero(flagged)}")
    require(np.array_equal(read4, shards[:, list(lost4)]),
            "4-loss degraded read differs")
    require(np.array_equal(read1, shards[:, [3]]),
            "XOR degraded read differs")
    require(torch.equal(rebuilt[:, 0], store[:, failed]),
            "rebuilt shard differs from the original")
    require(torch.equal(rebuilt_crcs.view(torch.int32), store_crcs[:, failed]),
            "rebuilt shard's CRCs differ from the stored CRCs")
    require(np.array_equal(full, cs) and np.array_equal(again, cc)
            and assembled == chunk, "4 MiB chunk round trip differs")
    require_main_path("the stripe server", launches,
                      ("gf2_matmul", "crc32c_blocks", "xor_reduce"))
    del store, rebuilt
    log(json.dumps({"requests": requests}))
    log(f"main-path launches {launches} over {len(requests)} requests "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches


# -- phase 8 -----------------------------------------------------------------
def hops(dev, cmp: Compare):
    """The codec's delta-parity and chain-encode hop ops on the card, held
    against their plain versions on the CPU; logs their times and returns
    the run's launch counts."""
    from tpu3fs_torch.ops.crc32c import crc32c_xor
    from tpu3fs_torch.ops.gf256 import GF
    from tpu3fs_torch.ops.stripe import StripeCodec

    t0 = phase("phase 8: chain-encode hops (delta_parity, hop_accumulate)")
    codec = StripeCodec(K, M, S_WRITE, device=dev)
    plain = StripeCodec(K, M, S_WRITE, device="cpu")
    rng = np.random.default_rng(7)
    B, S, j = B_WRITE, S_WRITE, 5
    deltas = rng.integers(0, 256, (B, S), dtype=np.uint8)
    lens = rng.integers(0, S + 1, B)
    lens[:2] = (0, S)  # an empty and a full shard among the trimmed ones
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in lens]
    start = rng.integers(0, 256, (B, M, S), dtype=np.uint8)

    zero_counts()
    delta = codec.delta_parity(j, deltas)
    acc_np = start.copy()
    crcs_np = codec.hop_accumulate(j, payloads, acc_np)
    acc_dev = torch.tensor(start, device=dev)  # a copy
    crcs_dev = codec.hop_accumulate(j, payloads, acc_dev)
    torch.cuda.synchronize()
    counts = read_counts()
    require_main_path("the chain-encode hops", counts,
                      ("gf2_matmul", "crc32c_blocks"))

    want_delta = plain.delta_parity(j, deltas)
    acc_cpu = start.copy()
    want_crcs = plain.hop_accumulate(j, payloads, acc_cpu)
    as_t = torch.from_numpy
    cmp(as_t(delta), as_t(want_delta), "delta_parity")
    cmp(as_t(acc_np), as_t(acc_cpu), "hop_accumulate, numpy accumulator")
    cmp(acc_dev.cpu(), as_t(acc_cpu), "hop_accumulate, device accumulator")
    want_crcs = as_t(want_crcs.astype(np.int64))
    cmp(as_t(crcs_np.astype(np.int64)), want_crcs, "hop CRCs, numpy")
    cmp(as_i64(crcs_dev).cpu(), want_crcs, "hop CRCs, device")
    col = codec.rs.parity_delta_matrix(j)
    gold = np.stack([GF.MUL_TABLE[int(c)][deltas[0]] for c in col[:, 0]])
    require(np.array_equal(delta[0], gold), "delta rows differ from the gold")
    # the hop CRC composes: crc(acc') = crc(acc) ^ crc(contribution) ^ crc(0)
    before, after = codec.crc_batch(start[0]), codec.crc_batch(acc_np[0])
    require(all(crc32c_xor(int(before[i]), int(crcs_np[0, i]), S)
                == int(after[i]) for i in range(M)),
            "hop CRCs do not compose to the accumulator's CRCs")

    # times: the device-resident ops with CUDA events; the numpy and bytes
    # requests on the host clock, ending in a synchronise
    d_dev = torch.from_numpy(deltas).to(dev)

    def hop_device():
        contrib = codec.rs.gf_accumulate(j, d_dev, acc_dev)
        return codec.crc_batch(contrib.reshape(B * M, S))

    def host_ms(fn, n=3):
        runs = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        return sorted(runs)[n // 2]

    out = {
        "delta_parity_device_ms": cuda_ms(lambda: codec.rs.delta_parity(j, d_dev), 30),
        "delta_parity_bound_ms": (B * S + B * M * S) / HBM_BYTES_PER_S * 1e3,
        "hop_device_ms": cuda_ms(hop_device, 30),
        "hop_bound_ms": (B * S + 2 * B * M * S + 4 * B * M)
        / HBM_BYTES_PER_S * 1e3,
        "delta_parity_numpy_host_ms": host_ms(lambda: codec.delta_parity(j, deltas)),
        "hop_bytes_device_acc_host_ms": host_ms(
            lambda: codec.hop_accumulate(j, payloads, acc_dev)),
        "hop_bytes_numpy_acc_host_ms": host_ms(
            lambda: codec.hop_accumulate(j, payloads, acc_np)),
        "shapes": "RS(12,4), j=5, B=12 stripes, S=1 MiB",
    }
    log(json.dumps({"hop_ops": out}))
    log(f"hops: launches {counts}, {cmp.cases} comparisons equal "
        f"({time.perf_counter() - t0:.1f} s)")
    return counts


# -- phase 9 -----------------------------------------------------------------
def multi_device(dev):
    """dryrun_multichip, a checksummed chain write and a shuffle on a
    one-rank NCCL group; logs the chain step's time and returns the run's
    launch counts."""
    import torch.distributed as dist

    from tpu3fs_torch.entry import dryrun_chain_len, dryrun_multichip
    from tpu3fs_torch.ops.crc32c import BatchCrc32c
    from tpu3fs_torch.parallel import (backend_for, chain_write_step,
                                       make_storage_mesh, shuffle_partitions)

    t0 = phase("phase 9: the multi-device path on a one-rank NCCL group")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group(backend_for(dev),
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    try:
        mesh = make_storage_mesh(dryrun_chain_len(1), device=dev)
        crc = BatchCrc32c(S_WRITE, device=dev)
        rows = rand_u8((B_WRITE, S_WRITE), 80, dev)
        part = rand_u8((2, 4, 4096), 81, dev)
        zero_counts()
        t = time.perf_counter()
        shape = dryrun_multichip(mesh)
        replica, ok = chain_write_step(mesh, rows, crc_fn=crc)
        shuffled = shuffle_partitions(mesh, part)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t) * 1e3
        counts = read_counts()
        require_main_path("the multi-device path", counts,
                          ("crc32c_blocks", "xor_fold_crc"))
        require(shape == (1, 1), f"dry run mesh {shape}, want (1, 1)")
        require(bool(ok.all()) and torch.equal(replica[0], rows),
                "chain write: replica or checksum cross-check differs")
        require(torch.equal(shuffled, part), "one-rank shuffle moved rows")
        out = {"host_ms": run_ms,
               "chain_write_step_ms": cuda_ms(
                   lambda: chain_write_step(mesh, rows, crc_fn=crc), 30),
               "chain_write_step_bound_ms": 3 * B_WRITE * S_WRITE
               / HBM_BYTES_PER_S * 1e3,
               "shapes": "one rank, mesh (1, 1); chain write of 12 x 1 MiB "
                         "rows, BatchCrc32c(1 MiB)"}
    finally:
        dist.destroy_process_group()
    log(json.dumps({"multi_device": out}))
    log(f"multi-device: launches {counts} ({time.perf_counter() - t0:.1f} s)")
    return counts


# -- phase 10 ----------------------------------------------------------------
# the storage tier's shapes: 1 MiB CR chunks (DEFAULT_CHUNK_SIZE) on a chain
# of 3, 4 MiB EC chunks at RS(12,4) over 16 nodes
CR_CHUNK, CR_CHUNKS, EC_STRIPES = MIB, 64, 16
FIRST_NODE, FIRST_TARGET, CR_CHAIN, EC_CHAIN = 10, 1000, 900_001, 900_002
CRC_LENGTHS = [0, 1, 511, 512, 513, S_CHUNK, MIB + 3]
_TUPLE_ARGS = {"stat_chunks", "remove_chunk", "remove_file_chunks",
               "query_last_chunk", "truncate_file_chunks"}
_METHODS = _TUPLE_ARGS | {
    "write", "write_shard", "update", "read", "read_rebuild",
    "batch_read_rebuild", "batch_read", "batch_write", "batch_update",
    "batch_write_shard", "chain_encode", "dump_chunkmeta",
    "dump_pending_chunkmeta", "sync_done"}


class Tier:
    """16 StorageServices in one process over a hand-made RoutingInfo: the
    CR chain on nodes 0, 2 and 3, the EC chain over all 16, one target of
    a chain per node. ``send`` is a direct-dispatch messenger modelled on
    the fabric's, marked ``in_process`` as the fabric is; the tier plays
    mgmtd's part (``fail_node``, ``rejoin_node``, ``promote_synced``)."""

    in_process = True

    def __init__(self, dev):
        from tpu3fs_torch.mgmtd import types as T
        from tpu3fs_torch.storage.craq import StorageService
        from tpu3fs_torch.storage.target import StorageTarget

        self.T, self.dev, self.Target = T, dev, StorageTarget
        self.routing = T.RoutingInfo(version=1)
        self.services, self.down, self.synced = {}, set(), set()
        for i in range(K + M):
            nid = FIRST_NODE + i
            self.routing.nodes[nid] = T.NodeInfo(
                nid, T.NodeType.STORAGE,
                status=T.NodeStatus.HEARTBEAT_CONNECTED)
            self.services[nid] = StorageService(nid, lambda: self.routing,
                                                self.send, device=dev)
        tid = FIRST_TARGET
        for chain_id, nodes, k, m, size in (
                (CR_CHAIN, [0, 2, 3], 0, 0, CR_CHUNK),
                (EC_CHAIN, range(K + M), K, M, S_CHUNK)):
            tids = []
            for ni in nodes:
                self.routing.targets[tid] = T.TargetInfo(
                    tid, node_id=FIRST_NODE + ni, chain_id=chain_id,
                    public_state=T.PublicTargetState.SERVING,
                    local_state=T.LocalTargetState.UPTODATE)
                self.services[FIRST_NODE + ni].add_target(StorageTarget(
                    tid, chain_id, chunk_size=size, device=dev))
                tids.append(tid)
                tid += 1
            self.routing.chains[chain_id] = T.ChainInfo(
                chain_id, 1, [T.ChainTarget(t) for t in tids], tids,
                ec_k=k, ec_m=m)

    def send(self, node_id: int, method: str, payload):
        from tpu3fs_torch.utils.result import Code, FsError, Status

        if node_id in self.down or node_id not in self.services:
            raise FsError(Status(Code.RPC_CONNECT_FAILED, f"node {node_id} down"))
        if method not in _METHODS:
            raise FsError(Status(Code.RPC_METHOD_NOT_FOUND, method))
        if method == "sync_done":
            self.synced.add(payload)
        fn = getattr(self.services[node_id], method)
        return fn(*payload) if method in _TUPLE_ARGS else fn(payload)

    def node_of(self, target_id: int) -> int:
        return self.routing.targets[target_id].node_id

    def service_of(self, target_id: int):
        return self.services[self.node_of(target_id)]

    def chain(self, chain_id: int):
        return self.routing.chains[chain_id]

    def _set_state(self, target_id: int, state) -> None:
        info = self.routing.targets[target_id]
        info.public_state = state
        chain = self.routing.chains[info.chain_id]
        ct = next(t for t in chain.targets if t.target_id == target_id)
        ct.public_state = state
        if state != self.T.PublicTargetState.SERVING:
            chain.targets.remove(ct)  # to the chain's end, as mgmtd does
            chain.targets.append(ct)
        chain.chain_version += 1
        self.routing.version += 1

    def fail_node(self, node_id: int) -> None:
        self.down.add(node_id)
        for tid, info in self.routing.targets.items():
            if info.node_id == node_id:
                self._set_state(tid, self.T.PublicTargetState.OFFLINE)

    def rejoin_node(self, node_id: int, wipe: bool) -> None:
        self.down.discard(node_id)
        svc = self.services[node_id]
        for tid, info in self.routing.targets.items():
            if info.node_id != node_id:
                continue
            if wipe:  # a replaced disk: an empty engine
                old = svc.drop_target(tid)
                svc.add_target(self.Target(tid, old.chain_id,
                                           chunk_size=old.chunk_size,
                                           device=self.dev))
            self._set_state(tid, self.T.PublicTargetState.SYNCING)

    def promote_synced(self) -> list:
        done = sorted(self.synced)
        for tid in done:
            self._set_state(tid, self.T.PublicTargetState.SERVING)
        self.synced.clear()
        return done

    def stored(self) -> dict:
        """target id -> [(chunk id, versions, length, CRC, pending length
        and CRC, aux, committed bytes)] of every target."""
        out = {}
        for svc in self.services.values():
            for target in svc.targets():
                eng = target.engine
                out[target.target_id] = [
                    ((m.chunk_id.file_id, m.chunk_id.index), m.committed_ver,
                     m.pending_ver, m.length, m.checksum.value,
                     m.pending_length, m.pending_checksum.value, m.aux,
                     eng.read(m.chunk_id) if m.committed_ver else b"")
                    for m in eng.all_metadata()]
        return out

    def close(self) -> None:
        for svc in self.services.values():
            svc.stop_workers()


def storage_inputs() -> dict:
    """The storage phase's requests' payloads, from one seed: 64 CR chunks
    of 1 MiB down to 1 MiB - 63 x 4099 bytes, 32 partial overwrites, 16 EC
    stripes of 4 MiB down to 4 MiB - 15 S/3, 32 chunks written while the CR
    tail is down."""
    rng = np.random.default_rng(31)
    u8 = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    cr = [u8(CR_CHUNK - (CR_CHUNK // 256 + 3) * i) for i in range(CR_CHUNKS)]
    over = []
    for i in range(0, CR_CHUNKS, 2):
        off = int(rng.integers(0, len(cr[i])))
        over.append((i, off, u8(int(rng.integers(1, CR_CHUNK - off + 1)))))
    ec = [u8(CHUNK_BYTES - (S_CHUNK // 3) * i) for i in range(EC_STRIPES)]
    late = [u8(CR_CHUNK) for _ in range(1, CR_CHUNKS, 2)]
    return {"cr": cr, "over": over, "ec": ec, "late": late}


def timed_request(requests: dict, name: str, fn, dev, trace: bool):
    """Run one request ``fn()`` on ``dev`` and record in ``requests[name]``
    its host time (ending in a synchronise), the kernel launches it made
    and, with ``trace``, its device time from a torch.profiler trace of
    the device's activity."""
    from torch.profiler import ProfilerActivity, profile

    before = read_counts()
    with (profile(activities=[ProfilerActivity.CUDA]) if trace
          else contextlib.nullcontext()) as prof:
        t = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
    after = read_counts()
    row = {"host_ms": host_ms, "launches": {
        n: after[n] - before[n] for n in after if after[n] != before[n]}}
    if trace:
        row.update(device_split(prof))
        row["device_share"] = row["device_ms"] / host_ms
    requests[name] = row
    return out


def storage_run(dev, inputs: dict, trace: bool = False) -> dict:
    """Steps 1-6 of the storage phase on a fresh tier on ``dev``: the
    record of every reply and read, the stored state, and each request's
    host time (and, with ``trace``, its device time from a torch.profiler
    trace). Every byte read back or rebuilt is checked here."""
    from dataclasses import replace

    from tpu3fs_torch.ops.stripe import get_codec
    from tpu3fs_torch.storage.craq import ReadReq, ShardWriteReq, WriteReq
    from tpu3fs_torch.storage.ec_resync import EcResyncWorker
    from tpu3fs_torch.storage.resync import ResyncWorker
    from tpu3fs_torch.storage.types import ChunkId

    tier = Tier(dev)
    codec = get_codec(K, M, S_CHUNK, device=dev)
    rec, requests = [], {}

    def request(name, fn):
        return timed_request(requests, name, fn, dev, trace)

    def reply(r):
        return (int(r.code), getattr(r, "update_ver", 0), r.commit_ver,
                r.checksum.value, r.checksum.length)

    try:
        # 1. CR: 64 chunks, partial overwrites, reads from every replica
        cr = tier.chain(CR_CHAIN)
        head = tier.service_of(cr.head().target_id)
        want = {ChunkId(7, i): bytearray(d) for i, d in enumerate(inputs["cr"])}

        def cr_write(items, seq):
            return head.batch_write([WriteReq(
                CR_CHAIN, tier.chain(CR_CHAIN).chain_version, cid, off, data,
                CR_CHUNK, client_id="smoke", channel_id=1 + n, seqnum=seq)
                for n, (cid, off, data) in enumerate(items)])

        got = request("cr_write_64x1MiB", lambda: cr_write(
            [(cid, 0, bytes(d)) for cid, d in want.items()], 1))
        rec.append(("cr.write", [reply(r) for r in got]))
        items = [(ChunkId(7, i), off, d) for i, off, d in inputs["over"]]
        got = request("cr_overwrite_32_partial", lambda: cr_write(items, 2))
        rec.append(("cr.overwrite", [reply(r) for r in got]))
        for cid, off, d in items:
            buf = want[cid]
            buf.extend(b"\x00" * max(0, off + len(d) - len(buf)))
            buf[off:off + len(d)] = d

        def read_all(tid):
            svc = tier.service_of(tid)
            return [svc.read(ReadReq(CR_CHAIN, cid, 0, -1, tid)) for cid in want]
        reads = request("cr_read_3x64", lambda: [read_all(t.target_id)
                                                 for t in cr.targets])
        for got in reads:
            require(all(r.ok and bytes(r.data) == want[cid]
                        for r, cid in zip(got, want)), "a CR replica's bytes")
            require([reply(r) for r in got] == [reply(r) for r in reads[0]],
                    "CR replicas' versions or checksums differ")
        rec.append(("cr.read", [reply(r) for r in reads[0]]))

        # 2-3. EC: 16 stripes client-encoded, the same 16 chain-encoded
        ec = tier.chain(EC_CHAIN)
        targets = [ec.target_of_shard(j).target_id for j in range(K + M)]

        def by_node(reqs):
            groups = {}
            for n, r in enumerate(reqs):
                groups.setdefault(tier.node_of(r.target_id), []).append(n)
            out = [None] * len(reqs)
            for nid, idxs in groups.items():
                for n, r in zip(idxs, tier.send(nid, "batch_write_shard",
                                                [reqs[n] for n in idxs])):
                    out[n] = r
            return out

        def shard_req(cid, j, data, payload, crc):
            return ShardWriteReq(
                chain_id=EC_CHAIN, chain_ver=ec.chain_version,
                target_id=targets[j], chunk_id=cid, data=payload, crc=crc,
                update_ver=1, chunk_size=S_CHUNK, logical_len=len(data),
                phase=1)

        def client_encoded():
            buf = np.zeros((EC_STRIPES, K, S_CHUNK), dtype=np.uint8)
            for b, data in enumerate(inputs["ec"]):
                buf[b].reshape(-1)[:len(data)] = np.frombuffer(data, np.uint8)
            parity, crcs = codec.encode_parity(buf)
            reqs = []
            for b, data in enumerate(inputs["ec"]):
                for j in range(K + M):
                    payload = (data[j * S_CHUNK:(j + 1) * S_CHUNK] if j < K
                               else parity[b, j - K].tobytes())
                    crc = (int(crcs[b, j]) if len(payload) == S_CHUNK
                           else codec.crc_host(payload))
                    reqs.append(shard_req(ChunkId(8, b), j, data, payload, crc))
            staged = by_node(reqs)
            return staged + by_node([replace(r, data=b"", crc=0, phase=2)
                                     for r in reqs])

        def chain_encoded():
            reqs = [shard_req(ChunkId(9, b), j, data,
                              data[j * S_CHUNK:(j + 1) * S_CHUNK] if j < K
                              else b"", -1)
                    for b, data in enumerate(inputs["ec"]) for j in range(K + M)]
            staged = tier.send(tier.node_of(targets[0]), "chain_encode", reqs)
            return staged + by_node([replace(r, data=b"", crc=0, phase=2)
                                     for r in reqs])

        for name, fn in (("ec.write_shard", client_encoded),
                         ("ec.chain_encode", chain_encoded)):
            got = request(f"{name[3:]}_16x4MiB", fn)
            require(all(r.ok for r in got), f"{name}: a shard was refused")
            rec.append((name, [reply(r) for r in got]))
        held = tier.stored()
        for tid in targets:  # the golden equality of the chain encode
            rows = {}
            for row in held[tid]:
                rows.setdefault(row[0][0], []).append(row[1:])
            require(rows[8] == rows[9], f"target {tid}: chain-encoded "
                    "shards differ from client-encoded ones")

        # 4. degraded read: data shard 1 and parity shard 12 down
        data_t, parity_t = targets[1], targets[K]
        before = held[data_t]
        tier.fail_node(tier.node_of(data_t))
        tier.fail_node(tier.node_of(parity_t))
        stripes = [(ChunkId(f, b), d) for f in (8, 9)
                   for b, d in enumerate(inputs["ec"])]

        def degraded_read():
            out = []
            chain = tier.chain(EC_CHAIN)
            for cid, _ in stripes:
                shards, logical = {}, 0
                for j in range(K + M):
                    t = chain.target_of_shard(j)
                    if len(shards) == K or not t.public_state.can_read:
                        continue
                    r = tier.service_of(t.target_id).read(ReadReq(
                        EC_CHAIN, cid, 0, -1, t.target_id, chunk_size=S_CHUNK))
                    require(r.ok, f"shard {j} of {cid}: {r.code!r}")
                    shards[j] = bytes(r.data).ljust(S_CHUNK, b"\x00")
                    logical = max(logical, r.logical_len)
                present = sorted(shards)
                lost = [j for j in range(K) if j not in shards]
                surv = np.stack([np.frombuffer(shards[j], np.uint8)
                                 for j in present])[None]
                back = codec.reconstruct_batch(present, lost, surv)
                for n, j in enumerate(lost):
                    shards[j] = back[0, n].tobytes()
                out.append(b"".join(shards[j] for j in range(K))[:logical])
            return out
        got = request("degraded_read_32x4MiB", degraded_read)
        require(got == [d for _, d in stripes], "a degraded read's bytes")
        rec.append(("ec.degraded_read", len(got)))

        # 5. EC rebuild of the data target onto an empty engine
        tier.rejoin_node(tier.node_of(data_t), wipe=True)
        coordinator = tier.chain(EC_CHAIN).serving_targets()[0].target_id
        worker = EcResyncWorker(tier.service_of(coordinator), tier.send,
                                batch_stripes=EC_STRIPES, device=dev)
        moved = request("ec_rebuild_round", worker.run_once)
        requests["ec_rebuild_round"]["rebuild_mibps"] = \
            worker.last_stats["mibps"]
        rec.append(("ec.rebuild", moved, tier.promote_synced()))
        require(moved == len(stripes), f"EC rebuild moved {moved}")
        require(tier.stored()[data_t] == before,
                "a rebuilt shard or its CRC differs from the original")

        # 6. CR resync: the tail misses 32 writes, then re-joins
        tail = cr.targets[-1].target_id
        tier.fail_node(tier.node_of(tail))
        items = [(ChunkId(7, i), 0, d)
                 for i, d in zip(range(1, CR_CHUNKS, 2), inputs["late"])]
        got = cr_write(items, 3)
        require(all(r.ok for r in got), "a write with the tail down")
        for cid, _, d in items:
            want[cid] = bytearray(d)
        tier.rejoin_node(tier.node_of(tail), wipe=False)
        moved = request("cr_resync_round", lambda: sum(
            ResyncWorker(svc, tier.send).run_once()
            for nid, svc in sorted(tier.services.items())
            if nid not in tier.down))
        rec.append(("cr.resync", moved, tier.promote_synced()))
        require(moved == len(items), f"CR resync moved {moved}")
        got = read_all(tail)
        require(all(r.ok and bytes(r.data) == want[cid]
                    for r, cid in zip(got, want)), "the resynced target's bytes")
        rec.append(("cr.read_resynced", [reply(r) for r in got]))
        return {"record": rec, "stored": tier.stored(), "requests": requests,
                "chunk0": (bytes(want[ChunkId(7, 0)]), got[0].checksum.value)}
    finally:
        tier.close()


def device_split(prof) -> dict:
    """Device time in a torch.profiler trace: kernels, copies, memsets (ms),
    summed over the device's own events. (An operator's self device time
    in ``key_averages()`` repeats the copies and kernels it launched, and
    the profiler builds those summaries slowly for a request of tens of
    thousands of launches, so the raw events are read instead.)"""
    from torch.autograd import DeviceType

    split = {"kernel_ms": 0.0, "copy_ms": 0.0, "memset_ms": 0.0}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        key = e.name().lower()
        kind = ("copy_ms" if "memcpy" in key else
                "memset_ms" if "memset" in key else "kernel_ms")
        split[kind] += (e.end_ns() - e.start_ns()) / 1e6
    split["device_ms"] = sum(split.values())
    return split


def storage(dev):
    """The storage tier answers requests on the card (the main path) and on
    the CPU with the plain versions: both routes must store the same bytes,
    versions and checksums. Returns the card run's launch counts, and the
    inputs and card run for ``storage_shares``."""
    from tpu3fs_torch.ops.crc32c import crc32c_many, crc32c_py

    t0 = phase("phase 10: the storage tier answers requests")
    rng = np.random.default_rng(32)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in CRC_LENGTHS]
    n_k2 = read_counts()["crc32c_blocks"]
    got = crc32c_many(bufs, device=dev)
    require(read_counts()["crc32c_blocks"] == n_k2 + 1,
            "crc32c_many is not one tensor-core K2 launch")
    require(got == [crc32c_py(b) for b in bufs],
            f"crc32c_many differs from crc32c_py at lengths {CRC_LENGTHS}")
    require(crc32c_many(bufs, device="cpu") == got,
            "crc32c_many's plain version differs on the CPU")
    inputs = storage_inputs()
    # warm-up: the codecs and the row codecs crc32c_many pads into
    storage_run(dev, {"cr": inputs["cr"][:4], "over": inputs["over"][:2],
                      "ec": inputs["ec"][:2], "late": inputs["late"][:2]})
    zero_counts()
    card = storage_run(dev, inputs)
    counts = read_counts()
    require_main_path("the storage tier", counts,
                      ("gf2_matmul", "crc32c_blocks"))
    chunk, crc = card["chunk0"]
    require(crc == crc32c_py(chunk), "a stored CRC differs from crc32c_py")
    t_cpu = time.perf_counter()
    cpu = storage_run(torch.device("cpu"), inputs)
    card["cpu_route_s"] = time.perf_counter() - t_cpu
    require_same_run(cpu, card, "the CPU run")
    log(f"storage: launches {counts}, CPU route "
        f"{card['cpu_route_s']:.1f} s ({time.perf_counter() - t0:.1f} s)")
    return counts, inputs, card


def require_same_run(run: dict, card: dict, name: str) -> None:
    require(run["record"] == card["record"],
            f"{name}'s replies differ from the card run's")
    require(run["stored"] == card["stored"],
            f"{name} stored other bytes, versions or checksums")


def storage_shares(dev, inputs: dict, card: dict) -> None:
    """Steps 1-6 again on the card, each request under torch.profiler for
    its device time (kernels, copies); logs every request's host time from
    the main path's run beside the traced run's host and device times.
    Runs after phase 15's traces, which its profiler sessions must not
    precede."""
    t0 = phase("phase 10 (continued): the storage requests' device time")
    traced = storage_run(dev, inputs, trace=True)
    require_same_run(traced, card, "the traced card run")
    rows = {name: dict(row, traced=traced["requests"][name])
            for name, row in card["requests"].items()}
    log(json.dumps({"storage_requests": rows,
                    "cpu_route_s": card["cpu_route_s"],
                    "shapes": "CR chain of 3, 1 MiB chunks; RS(12,4) over "
                              "16 nodes, 4 MiB chunks, S=349,696"}))
    log(f"storage shares ({time.perf_counter() - t0:.1f} s)")


# -- phase 11 ----------------------------------------------------------------
# the JAX package's serving benchmark with the device data plane
# (bench.py:286-337): RS(12,4) over 4 storage nodes and 2 chains, 1 MiB
# stripes (S = shard_size_of(1 MiB, 12) = 87,552), 48 a pass; the CR
# fabric of storage_bench (bench.py:199-201): 2 replicas, 4 chains, 64
# chunks of 256 KiB. The CPU route runs 4 stripes (and 4 CR chunks) a pass.
FAB_NODES, FAB_CHAINS, FAB_STRIPES, FAB_CPU_STRIPES = 4, 2, 48, 4
CR_FAB_CHUNK, CR_FAB_CHUNKS = 256 << 10, 64
GOLD_STRIPES = 4  # stripes of each pass held against encode_np, crc32c_py


class StepClock:
    """``time`` for the modules a run patches: ``time_ns`` counts from a
    fixed start; ``time`` is the real clock, or with ``step`` a wall clock
    that moves only when the run calls ``advance``; every other attribute
    is the real module's."""

    def __init__(self, step: bool = False, t: float = 1_800_000_000.0):
        self.step, self.t = step, t
        self._ns = itertools.count(1_700_000_000_000_000_000, 1_000_003)

    def time(self) -> float:
        return self.t if self.step else time.time()

    def time_ns(self) -> int:
        return next(self._ns)

    def advance(self, dt: float = 10.0) -> None:
        self.t += dt

    def __getattr__(self, name):
        return getattr(time, name)


@contextlib.contextmanager
def deterministic(seed: int, step_clock: bool = False):
    """EC stripe versions carry a writer nonce from ``os.urandom`` and a
    file's layout seed comes from meta's ``time.time_ns``: both drawn from
    ``seed`` for one run, so two runs of the sequence store the same
    versions on the same chains. Each draw size has its own stream (a
    nonce is 4 bytes), so other callers (uuid4's 16) cannot shift it.
    With ``step_clock`` the wall clock that stamps inode times, pin leases
    and the KV cache's touches is a StepClock too (yielded), so mtimes,
    and the GC's order by them, are the same on every run."""
    from unittest import mock

    from tpu3fs_torch.kvcache import cache, layout, leases
    from tpu3fs_torch.meta import store, types

    streams = {}

    def urandom(n: int) -> bytes:
        rng = streams.setdefault(n, np.random.default_rng([seed, n]))
        return rng.bytes(n)

    clock = StepClock(step_clock)
    mods = [store] + ([types, cache, leases, layout] if step_clock else [])
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch("os.urandom", urandom))
        for mod in mods:
            stack.enter_context(mock.patch.object(mod, "time", clock))
        yield clock


def serving_inputs(depth: int) -> dict:
    """The files of one pass, from one seed: ``/a`` and ``/b`` of
    ``depth`` stripes, the partial overwrite of ``/a``, ``/cr`` of
    ``depth`` (64 at full depth) chunks of 256 KiB."""
    rng = np.random.default_rng(41)
    u8 = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    cr = CR_FAB_CHUNKS if depth == FAB_STRIPES else depth
    return {"a": u8(depth * MIB), "patch": (MIB + 1000, u8(5000)),
            "b": u8(depth * MIB), "cr": u8(cr * CR_FAB_CHUNK)}


def fabric_stored(fab) -> dict:
    """target id -> [(chunk id, versions, length, CRC, pending length and
    CRC, aux, sha256 of the committed bytes)] of every target."""
    import hashlib

    out = {}
    for node in fab.nodes.values():
        for target in node.service.targets():
            eng = target.engine
            out[target.target_id] = sorted(
                ((m.chunk_id.file_id, m.chunk_id.index), m.committed_ver,
                 m.pending_ver, m.length, m.checksum.value,
                 m.pending_length, m.pending_checksum.value, m.aux,
                 hashlib.sha256(eng.read(m.chunk_id) if m.committed_ver
                                else b"").hexdigest())
                for m in eng.all_metadata())
    return out


def fabric_routing(fab) -> tuple:
    r = fab.routing()
    return (r.version, {cid: (c.chain_version,
                              [(t.target_id, t.public_state.name)
                               for t in c.targets])
                        for cid, c in sorted(r.chains.items())})


def serving_run(dev, depth: int, trace: bool = False) -> dict:
    """Steps 1-9 of the serving phase through ``Fabric.meta`` and
    ``Fabric.file_client()`` on ``dev``, ``depth`` stripes a pass: the
    record (replies' codes, sha256 of every read, every target's stored
    chunks, routing versions and target states, file lengths), each
    request's host time (and, with ``trace``, its device time), and the
    fabrics and files for the checks. Every byte read is checked here."""
    import hashlib
    from unittest import mock

    from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.storage.engine import MemChunkEngine

    inputs = serving_inputs(depth)
    rec, requests = {"reads": []}, {}

    def request(name, fn):
        return timed_request(requests, name, fn, dev, trace)

    fabs = []
    try:
        with deterministic(7):
            fab = Fabric(SystemSetupConfig(
                num_storage_nodes=FAB_NODES, num_chains=FAB_CHAINS,
                chunk_size=MIB, ec_k=K, ec_m=M), device=dev)
            fabs.append(fab)
            fio = fab.file_client()

            def write(name, path, body):
                res = fab.meta.create(path, flags=OpenFlags.WRITE |
                                      OpenFlags.CREATE, client_id="smoke")
                request(name, lambda: fio.write(res.inode, 0, body))
                return fab.meta.close(res.inode.id, res.session_id)

            def read(name, inode, want):
                got = request(name, lambda: fio.read(inode, 0, len(want)))
                require(got == want, f"{name}: the bytes read differ")
                rec["reads"].append((name, hashlib.sha256(got).hexdigest()))

            # 1-3: write, read, one partial overwrite inside stripe 1 (the
            # delta-parity read-modify-write)
            body = bytearray(inputs["a"])
            a = write("write", "/a", bytes(body))
            read("read", a, bytes(body))
            off, patch = inputs["patch"]
            request("overwrite_5000B", lambda: fio.write(a, off, patch))
            body[off:off + len(patch)] = patch
            body = bytes(body)
            # 4-7: fail the first node (4 shards of every stripe, m), read
            # degraded, restart it on empty engines and rebuild, read
            victim = sorted(fab.nodes)[0]
            held = [t.engine for t in fab.nodes[victim].service.targets()]
            lost = sum(e.used_size() for e in held)
            lost_chunks = sum(len(e.all_metadata()) for e in held)
            fab.fail_node(victim)
            rec["failed"] = fabric_routing(fab)
            read("degraded_read", a, body)
            for t in fab.nodes[victim].service.targets():
                t.engine = MemChunkEngine(device=dev)
            fab.restart_node(victim)
            moved = request("rebuild", lambda: fab.resync_all(rounds=6))
            requests["rebuild"]["lost_bytes"] = lost
            rec["moved"] = moved
            read("read_after_rebuild", a, body)
            # 8: the chain-encode hops on the services
            with mock.patch.dict("os.environ",
                                 {"TPU3FS_EC_CHAIN_ENCODE": "1"}):
                b = write("chain_encode_write", "/b", inputs["b"])
            read("chain_encoded_read", b, inputs["b"])
            rec["lengths"] = [fab.meta.stat(p).length for p in ("/a", "/b")]
            rec["routing"] = fabric_routing(fab)
            rec["stored"] = fabric_stored(fab)
            rec["encode_cpu_s"] = fio.storage.encode_cpu_s
            # 9: the CR fabric at storage_bench's shape
            cr_fab = Fabric(SystemSetupConfig(
                num_storage_nodes=3, num_chains=4, num_replicas=2,
                chunk_size=CR_FAB_CHUNK), device=dev)
            fabs.append(cr_fab)
            fab, fio = cr_fab, cr_fab.file_client()
            c = write("cr_write", "/cr", inputs["cr"])
            read("cr_read", c, inputs["cr"])
            rec["cr_routing"] = fabric_routing(cr_fab)
            rec["cr_stored"] = fabric_stored(cr_fab)
        require(rec["moved"] == lost_chunks, f"the rebuild moved "
                f"{rec['moved']} of the {lost_chunks} shards the node held")
        return {"record": rec, "requests": requests, "fabric": fabs[0],
                "files": {"/a": (a, body), "/b": (b, inputs["b"])},
                "encode_cpu_s": rec.pop("encode_cpu_s")}
    finally:
        for f in fabs:
            for node in f.nodes.values():
                node.service.stop_workers()


def check_fabric_gold(run: dict) -> int:
    """All shards of the first GOLD_STRIPES stripes of each file against
    ``RSCode.encode_np`` (trimmed as stored) and ``crc32c_py``, and every
    CRC the engines hold against ``crc32c_many`` over its bytes. Returns
    the number of chunks whose CRC was checked."""
    from tpu3fs_torch.ops.crc32c import crc32c_many, crc32c_py
    from tpu3fs_torch.ops.rs import RSCode
    from tpu3fs_torch.ops.stripe import shard_size_of
    from tpu3fs_torch.storage.types import ChunkId

    fab = run["fabric"]
    S = shard_size_of(MIB, K)
    rs = RSCode(K, M, device="cpu")
    routing = fab.routing()

    def engine_of(target_id):
        node = routing.node_of_target(target_id).node_id
        return fab.nodes[node].service.target(target_id).engine

    for path, (inode, body) in run["files"].items():
        for idx in range(GOLD_STRIPES):
            stripe = np.zeros((K, S), dtype=np.uint8)
            chunk = np.frombuffer(body[idx * MIB:(idx + 1) * MIB], np.uint8)
            stripe.reshape(-1)[:chunk.size] = chunk
            shards = np.concatenate([stripe, rs.encode_np(stripe[None])[0]])
            chain = routing.chains[inode.layout.chain_of_chunk(idx)]
            for j in range(K + M):
                eng = engine_of(chain.target_of_shard(j).target_id)
                cid = ChunkId(inode.id, idx)
                got = eng.read(cid)
                require(got == shards[j, :len(got)].tobytes(),
                        f"{path} stripe {idx} shard {j} differs from encode_np")
                require(eng.get_meta(cid).checksum.value == crc32c_py(got),
                        f"{path} stripe {idx} shard {j}: CRC vs crc32c_py")
    held, bufs = [], []
    for node in fab.nodes.values():
        for target in node.service.targets():
            for m in target.engine.all_metadata():
                held.append(m.checksum.value)
                bufs.append(target.engine.read(m.chunk_id))
    require(crc32c_many(bufs, device=fab.device) == held,
            "a CRC an engine holds differs from its bytes' CRC")
    return len(held)


def serving(dev):
    """The serving stack answers files on the card (the main path), after a
    full-size warm-up pass; then the same sequence at FAB_CPU_STRIPES
    stripes on the card and on the CPU, whose records must be identical.
    Returns the main run's launch counts and the run for
    ``serving_shares``."""
    t0 = phase("phase 11: the serving stack answers files")
    serving_run(dev, FAB_STRIPES)  # warm-up: allocator, codecs, row codecs
    zero_counts()
    card = serving_run(dev, FAB_STRIPES)
    counts = read_counts()
    require_main_path("the serving stack", counts,
                      ("gf2_matmul", "crc32c_blocks"))
    checked = check_fabric_gold(card)
    small = serving_run(dev, FAB_CPU_STRIPES)
    t_cpu = time.perf_counter()
    cpu = serving_run(torch.device("cpu"), FAB_CPU_STRIPES)
    card["cpu_route_s"] = time.perf_counter() - t_cpu
    require(cpu["record"] == small["record"],
            "the CPU run's replies, reads, stored chunks or routing differ "
            "from the card's")
    req = card["requests"]
    mibps = {name: (req[name].get("lost_bytes", FAB_STRIPES * MIB) / MIB)
             / (req[name]["host_ms"] / 1e3)
             for name in ("write", "read", "degraded_read", "rebuild")}
    card["mibps"] = mibps
    log(f"serving: launches {counts} (K3 xor_reduce "
        f"{counts['xor_reduce']}), {checked} CRCs checked, e2e MiB/s "
        f"{mibps}, encode_cpu_s {card['encode_cpu_s']}, CPU route "
        f"{card['cpu_route_s']:.1f} s ({time.perf_counter() - t0:.1f} s)")
    return counts, card


def serving_shares(dev, card: dict) -> None:
    """The serving sequence again on the card, each request under
    torch.profiler for its device time; logs every request's host time
    from the main path's run beside the traced run's host and device
    times. Runs after phase 15's traces, as ``storage_shares`` does."""
    t0 = phase("phase 11 (continued): the serving requests' device time")
    traced = serving_run(dev, FAB_STRIPES, trace=True)
    require(traced["record"] == card["record"],
            "the traced card run differs from the main path's run")
    rows = {name: dict(row, traced=traced["requests"][name])
            for name, row in card["requests"].items()}
    log(json.dumps({"serving_requests": rows, "e2e_mibps": card["mibps"],
                    "encode_cpu_s": card["encode_cpu_s"],
                    "cpu_route_s": card["cpu_route_s"],
                    "shapes": "RS(12,4) over 4 nodes and 2 chains, 1 MiB "
                              "stripes (S=87,552), 48 a pass; CR 2 replicas, "
                              "4 chains, 64 x 256 KiB"}))
    log(f"serving shares ({time.perf_counter() - t0:.1f} s)")


# -- phase 12 ----------------------------------------------------------------
# one 16-token block of Llama-3.1-8B's KV cache in float16 (its public
# config.json: 32 layers, 8 KV heads, head_dim 128): (layers, k/v, heads,
# tokens, head_dim), 2,097,152 B a page, 2,097,208 with its header. Session
# A is a 4,096-token prompt (256 blocks); B shares A's first 3,072 tokens
# (192 blocks) and adds 1,024 of its own (64), as the JAX package's kvcache
# benchmark shapes it (benchmarks/kvcache_bench.py:184-195). The fabric is
# phase 11's RS(12,4) one. The card-versus-CPU record runs 8 blocks of A,
# 6 of them shared, at full page width.
KV_PAGE = (32, 2, 8, 16, 128)
KV_BLOCK_TOKENS = KV_PAGE[3]
KV_FULL, KV_SMALL = (256, 192, 64), (8, 6, 2)   # A, shared, B's own
KV_TTL_S = 3600.0
KV_BUDGET = 512 * MIB        # the capacity pass's target: A's page bytes


def kv_pages(dev) -> tuple:
    """A's 256 pages and B's 64 own pages, float16 integers in [-3, 3)
    drawn on the card from one seed: (host numpy pages, card tensors)."""
    g = torch.Generator(device=dev).manual_seed(1000)
    n_a, _, n_own = KV_FULL
    t = torch.randint(-3, 3, (n_a + n_own, *KV_PAGE), generator=g,
                      device=dev, dtype=torch.int8).to(torch.float16)
    host = t.cpu().numpy()
    return [host[i] for i in range(len(host))], t


class LoopbackPeers:
    """The peer client's surface (peer_read, fill_claim, fill_release),
    dispatching straight into the other members' ServingHosts: the fleet
    ladder with no transport and no deadline."""

    def __init__(self):
        self.hosts = {}

    def peer_read(self, ep, keys, *, serve_through=True, est_bytes=0,
                  deadline_s=None):
        from tpu3fs_torch.serving.service import PeerReadReq

        return self.hosts[ep.node_id].peer_read(
            PeerReadReq(keys=list(keys), serve_through=serve_through))

    def fill_claim(self, ep, key, owner, ttl_ms=2000):
        from tpu3fs_torch.serving.service import FillClaimReq

        return self.hosts[ep.node_id].fill_claim(
            FillClaimReq(key=key, owner=owner, ttl_ms=ttl_ms))

    def fill_release(self, ep, key, owner):
        from tpu3fs_torch.serving.service import FillReleaseReq

        return self.hosts[ep.node_id].fill_release(
            FillReleaseReq(key=key, owner=owner))

    def close(self):
        self.hosts.clear()


@contextlib.contextmanager
def held_flusher(cache):
    """Park a TieredKVCache's write-back flusher for the block, then start
    a fresh one: what was buffered meanwhile drains in ``flush_batch``
    batches in append order, the same batches on every run."""
    import threading

    cache._stop.set()
    with cache._cond:
        cache._cond.notify_all()
    cache._flusher.join(timeout=10)
    require(not cache._flusher.is_alive(), "the write-back flusher did not "
            "park")
    try:
        yield
    finally:
        cache._stop.clear()
        cache._flusher = threading.Thread(
            target=cache._flush_loop, daemon=True, name="kvcache-flush")
        cache._flusher.start()


def reclaim(fab) -> int:
    """``Fabric.run_gc`` until no removed file is left (one call takes at
    most 64): the chunks of every removed entry are gone after it."""
    total = n = fab.run_gc()
    while n:
        n = fab.run_gc()
        total += n
    return total


def kv_run(dev, sizes: tuple, pages: list, sources, trace: bool = False,
           digest: bool = False) -> dict:
    """Steps 1-6 of the KV-cache phase on a fresh RS(12,4) fabric on
    ``dev``: ``sizes`` = (A's blocks, shared, B's own), ``pages`` A's then
    B's own host pages, ``sources`` the same pages as tensors on ``dev``,
    against which every block that lands there is checked bit for bit.
    Returns the record (replies, fleet counters, GC removals; with
    ``digest`` also the sha256 of every block read and every target's
    stored chunks), each request's host time (with ``trace`` its device
    time; for a get, its fs read, decode and copy times) and the bytes
    each end-to-end rate is over."""
    import hashlib

    from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
    from tpu3fs_torch.kvcache import (KVCacheClient, KVCacheGC, LeaseManager,
                                      PrefixBlockStore)
    from tpu3fs_torch.mgmtd.types import ServingEndpoint
    from tpu3fs_torch.serving import FleetKVCache, ServingHost

    n_a, shared, own = sizes
    bt = KV_BLOCK_TOKENS
    toks_a = list(range(n_a * bt))
    toks_b = toks_a[:shared * bt] + [10_000_000 + t for t in range(own * bt)]
    pages_a, pages_own = pages[:n_a], pages[KV_FULL[0]:KV_FULL[0] + own]
    src_a = [sources[i] for i in range(n_a)]
    src_b = src_a[:shared] + [sources[KV_FULL[0] + i] for i in range(own)]
    page_bytes = pages_a[0].nbytes
    rec, requests = {"blocks": {}, "counters": {}}, {}
    endpoints = {n: ServingEndpoint(node_id=n) for n in (1, 2)}
    routing = SimpleNamespace(serving=endpoints)
    cap = 2 * (n_a + own) * (page_bytes + 4096)   # host tier, dirty buffer

    def request(name, fn):
        return timed_request(requests, name, fn, dev, trace)

    fleet, store, leases = {}, {}, {}
    peers = LoopbackPeers()
    fab = None
    try:
        with deterministic(11, step_clock=True) as clock:
            fab = Fabric(SystemSetupConfig(
                num_storage_nodes=FAB_NODES, num_chains=FAB_CHAINS,
                chunk_size=MIB, ec_k=K, ec_m=M), device=dev)
            for n in (1, 2):
                fs = KVCacheClient(fab.meta, fab.file_client(),
                                   client_id=f"member{n}", inode_cache=4096)
                fleet[n] = FleetKVCache(
                    fs, node_id=n, routing=lambda: routing,
                    peer_client=peers, capacity_bytes=cap,
                    dirty_max_bytes=cap)
                peers.hosts[n] = ServingHost(fleet[n], n,
                                             claims=fleet[n].claims)
                leases[n] = LeaseManager(fab.meta, owner=f"member{n}",
                                         default_ttl_s=KV_TTL_S)
                store[n] = PrefixBlockStore(fleet[n], block_tokens=bt,
                                            leases=leases[n])

            def get(name, n, toks, want, count=None, gone=()):
                """``get_blocks(device=dev)``, timed by stage; every block
                equal to its source on ``dev`` (a block at an index in
                ``gone`` may also be a miss, never zeros)."""
                s0 = dict(store[n].stage_s)
                got = request(name, lambda: store[n].get_blocks(
                    toks, count=count, device=dev))
                requests[name].update({
                    f"get_{k}_ms": (store[n].stage_s[k] - s0[k]) * 1e3
                    for k in s0})
                shas = []
                for i, (blk, w) in enumerate(zip(got, want)):
                    if blk is None:
                        require(i in gone, f"{name}: block {i} is missing")
                        shas.append(None)
                        continue
                    require(blk.device.type == dev.type and
                            blk.dtype == w.dtype and blk.shape == w.shape and
                            torch.equal(blk.view(torch.int16),
                                        w.view(torch.int16)),
                            f"{name}: block {i} differs from its page")
                    shas.append(hashlib.sha256(
                        blk.cpu().numpy().tobytes()).hexdigest()
                        if digest else True)
                require(len(got) == len(want), f"{name}: {len(got)} blocks")
                rec["blocks"][name] = shas
                rec["counters"][name] = {m: fleet[m].counters()
                                         for m in (1, 2)}

            def clear_tiers():
                for m in (1, 2):
                    fleet[m].tier.clear()

            # 1: member 1 stores A write-through (one batch_put)
            clock.advance()
            rec["put_a"] = request("put_a_write_through", lambda: store[1]
                                   .append_blocks(toks_a, pages_a,
                                                  write_through=True))
            # 2: member 2 matches B's prefix, pins it and gets it: peer
            # fills from member 1's host tier
            clock.advance()
            m = request("match_prefix_b",
                        lambda: store[2].match_prefix(toks_b))
            rec["match_b"] = (m.blocks, m.tokens, m.keys)
            lease = request("pin_prefix_b", lambda: store[2].pin_prefix(m))
            rec["pinned"] = list(lease.keys)
            get("get_b_prefix_peer_fill", 2, toks_b, src_b[:shared],
                count=m.blocks)
            # 3: B's own blocks through member 2's write-back buffer
            clock.advance()
            with held_flusher(fleet[2]):
                rec["append_b"] = request(
                    "append_b_write_back", lambda: store[2].append_blocks(
                        toks_b, pages_own, start_block=shared))
            drained = request("flush_b", lambda: fleet[2].flush(timeout=300))
            require(drained and fleet[2].dirty_bytes() == 0
                    and not fleet[2].flush_poisoned,
                    "the write-back buffer did not drain")
            # 4: A cold from the fs tier, then warm from the host tier
            clock.advance()
            clear_tiers()
            m = request("match_prefix_a",
                        lambda: store[1].match_prefix(toks_a))
            rec["match_a"] = (m.blocks, m.tokens)
            get("get_a_cold_fs_tier", 1, toks_a, src_a)
            get("get_a_warm_host_hit", 1, toks_a, src_a)
            # 5: the first node fails (m shards of every stripe); B from
            # the fs tier through degraded reads; restart and resync
            clock.advance()
            victim = sorted(fab.nodes)[0]
            fab.fail_node(victim)
            clear_tiers()
            get("get_b_degraded", 2, toks_b, src_b)
            fab.restart_node(victim)
            rec["resynced"] = request("resync", lambda: fab.resync_all(
                rounds=6))
            if digest:
                rec["stored"] = fabric_stored(fab)
            # 6: the capacity pass with A's shared prefix pinned, every
            # removed entry's chunks reclaimed, both sessions read again
            # (a GC'd block is a miss, never zeros), unpin, a TTL pass
            clock.advance()
            gc = KVCacheGC(fab.meta, ttl_s=KV_TTL_S, max_shards=1 << 20)
            budget = n_a * page_bytes
            rec["gc_capacity"] = request("gc_capacity_pass", lambda: gc
                                         .capacity_pass(now=clock.t,
                                                        capacity_bytes=budget))
            keys = {"a": store[1].block_keys(toks_a),
                    "b": store[2].block_keys(toks_b)}
            rec["present"] = {s: fleet[1].fs.batch_contains(k)
                              for s, k in keys.items()}
            require(all(rec["present"]["a"][:shared]),
                    "the capacity pass removed a pinned block")
            require(rec["gc_capacity"] == own + 1 and
                    not any(rec["present"]["a"][shared:]),
                    f"the capacity pass removed {rec['gc_capacity']} "
                    f"entries: want A's unpinned tail and one of B's")
            rec["gc_chunks"] = request("run_gc", lambda: reclaim(fab))
            clear_tiers()
            gone = {s: {i for i, p in enumerate(rec["present"][s]) if not p}
                    for s in keys}
            get("get_b_after_gc", 2, toks_b, src_b, gone=gone["b"])
            get("get_a_after_gc", 1, toks_a, src_a, gone=gone["a"])
            for s, name in (("a", "get_a_after_gc"), ("b", "get_b_after_gc")):
                require([x is not None for x in rec["blocks"][name]]
                        == rec["present"][s],
                        f"{name}: a GC'd block was served, or a kept one "
                        "missed")
            rec["unpinned"] = request("unpin_b",
                                      lambda: leases[2].unpin(lease))
            rec["gc_ttl"] = request("gc_ttl_pass", lambda: gc.run_once(
                now=clock.t + KV_TTL_S + 1))
            rec["gc_ttl_chunks"] = reclaim(fab)
            rec["present_after"] = fleet[1].fs.batch_contains(
                keys["a"] + keys["b"])
            require(not any(rec["present_after"]),
                    "an entry outlived the TTL pass")
            rec["hosts"] = {n: vars(peers.hosts[n].stats()) for n in (1, 2)}
        require(rec["put_a"] == n_a and rec["append_b"] == own and
                rec["match_b"][0] == shared and rec["match_a"][0] == n_a,
                "stored or matched block counts are off")
        require(rec["counters"]["get_b_prefix_peer_fill"][2]["peer_hits"]
                == shared, "member 2's prefix did not come from its peer")
        return {"record": rec, "requests": requests,
                "bytes": {"put": n_a * page_bytes, "flush": own * page_bytes,
                          "peer_fill": shared * page_bytes,
                          "cold": n_a * page_bytes, "warm": n_a * page_bytes,
                          "degraded": (shared + own) * page_bytes}}
    finally:
        for n in fleet:
            fleet[n].close(flush=False)
        if fab is not None:
            for node in fab.nodes.values():
                node.service.stop_workers()


def kvcache(dev):
    """The KV-cache serving tier on the card: the sequence at small depth
    on the card (also the warm-up), then at full size (the main path),
    then at small depth on the CPU, whose record must equal the card's.
    Returns the main run's launch counts and the run for ``kv_shares``."""
    t0 = phase("phase 12: the KV-cache serving tier answers prefix blocks")
    pages, sources = kv_pages(dev)
    t_pages = time.perf_counter() - t0
    small = kv_run(dev, KV_SMALL, pages, sources, digest=True)
    zero_counts()
    card = kv_run(dev, KV_FULL, pages, sources)
    counts = read_counts()
    require_main_path("the KV-cache tier", counts,
                      ("gf2_matmul", "crc32c_blocks"))
    t_cpu = time.perf_counter()
    cpu = kv_run(torch.device("cpu"), KV_SMALL, pages, sources.cpu(),
                 digest=True)
    card["cpu_route_s"] = time.perf_counter() - t_cpu
    require(cpu["record"] == small["record"],
            "the CPU run's replies, blocks, stored chunks or GC removals "
            "differ from the card's")
    card["pages_s"] = t_pages
    req, nbytes = card["requests"], card["bytes"]
    gib = lambda n, ms: n / (1 << 30) / (ms / 1e3)  # noqa: E731
    card["e2e"] = {
        "write_through_put_GiB_s": gib(nbytes["put"],
                                       req["put_a_write_through"]["host_ms"]),
        "write_back_flush_GiB_s": gib(nbytes["flush"],
                                      req["flush_b"]["host_ms"]),
        "cold_fs_tier_get_GiB_s": gib(nbytes["cold"],
                                      req["get_a_cold_fs_tier"]["host_ms"]),
        "peer_fill_GiB_s": gib(nbytes["peer_fill"],
                               req["get_b_prefix_peer_fill"]["host_ms"]),
        "host_hit_GiB_s": gib(nbytes["warm"],
                              req["get_a_warm_host_hit"]["host_ms"]),
        "degraded_get_GiB_s": gib(nbytes["degraded"],
                                  req["get_b_degraded"]["host_ms"]),
        "prefix_4096_tokens_on_card_ms": (
            req["match_prefix_a"]["host_ms"]
            + req["get_a_cold_fs_tier"]["host_ms"]),
    }
    log(f"kvcache: launches {counts}, e2e {json.dumps(card['e2e'])}, CPU "
        f"route {card['cpu_route_s']:.1f} s, pages {t_pages:.1f} s "
        f"({time.perf_counter() - t0:.1f} s)")
    return counts, card, (pages, sources)


def kv_shares(dev, card: dict, data: tuple) -> None:
    """The full-size KV-cache sequence again on the card, each request
    under torch.profiler for its device time; logs each request's host
    time, launches and get stages from the main path's run beside the
    traced run's host and device times. Runs after phase 15's traces, as
    ``storage_shares`` does."""
    t0 = phase("phase 12 (continued): the KV-cache requests' device time")
    traced = kv_run(dev, KV_FULL, *data, trace=True)
    require(traced["record"] == card["record"],
            "the traced card run differs from the main path's run")
    rows = {name: dict(row, traced=traced["requests"][name])
            for name, row in card["requests"].items()}
    log(json.dumps({"kvcache_requests": rows, "e2e": card["e2e"],
                    "cpu_route_s": card["cpu_route_s"],
                    "pages_s": card["pages_s"],
                    "shapes": "Llama-3.1-8B KV pages (32, 2, 8, 16, 128) "
                              "float16, 2,097,208 B an entry; A 256 blocks, "
                              "B 192 shared + 64; RS(12,4) over 4 nodes and "
                              "2 chains, 1 MiB chunks"}))
    for name, row in rows.items():
        tr = row["traced"]
        log(f"  {name:<24} host {row['host_ms']:10.3f} ms  K1 "
            f"{row['launches'].get('gf2_matmul', 0):4d} K2 "
            f"{row['launches'].get('crc32c_blocks', 0):6d} K3 "
            f"{row['launches'].get('xor_reduce', 0):3d}  share "
            f"{tr.get('device_share', 0.0):.4f}"
            + (f"  fs_read {row['get_fs_read_ms']:.3f} decode "
               f"{row['get_decode_ms']:.3f} copy {row['get_copy_ms']:.3f} ms"
               if "get_fs_read_ms" in row else ""))
    log(f"kvcache shares ({time.perf_counter() - t0:.1f} s)")


# -- phase 13 ----------------------------------------------------------------
# one decoder layer of Llama-3.1-8B at the widths of its public config.json
# (hidden 4096, 32 query heads and 8 KV heads of 128, intermediate 14336)
# in float32, the master weights of a mixed-precision run: 218,112,000
# parameters, 872,448,000 B a step (1 of the 32 layers; no embeddings, no
# AdamW moments). Tokenized pretraining sequences of 8,192 tokens (Llama
# 3's context), int32 (its vocabulary of 128,256 does not fit in 16 bits):
# a record is 32 KiB; 4,096 records (128 MiB) in 4 files; global batch 64,
# depth 2, so an epoch is 64 steps. The fabric is phase 11's RS(12,4) one.
# The card-versus-CPU record runs 2 leaves of 1 MiB and 64 records.
LLAMA_LAYER = {
    "self_attn.q_proj.weight": (4096, 4096),
    "self_attn.k_proj.weight": (1024, 4096),
    "self_attn.v_proj.weight": (1024, 4096),
    "self_attn.o_proj.weight": (4096, 4096),
    "mlp.gate_proj.weight": (14336, 4096),
    "mlp.up_proj.weight": (14336, 4096),
    "mlp.down_proj.weight": (4096, 14336),
    "input_layernorm.weight": (4096,),
    "post_attention_layernorm.weight": (4096,),
}
SEQ_TOKENS, VOCAB = 8192, 128_256
TRAIN_FULL = dict(leaves=LLAMA_LAYER, records=4096, files=4, batch=64,
                  cut=24)
TRAIN_SMALL = dict(leaves={"a.weight": (512, 512), "b.weight": (256, 1024)},
                   records=64, files=4, batch=8, cut=3)


def train_data(dev, sizes: dict) -> dict:
    """The layer's leaves (normal float32) and the token records (uniform
    below the vocabulary), drawn on ``dev`` from one seed; the records
    also as host bytes, what the packer writes."""
    g = torch.Generator(device=dev).manual_seed(2024)
    leaves = {f"model.layers.0.{k}": torch.randn(shape, generator=g,
                                                 device=dev)
              for k, shape in sizes["leaves"].items()}
    tokens = torch.randint(0, VOCAB, (sizes["records"], SEQ_TOKENS),
                           generator=g, device=dev, dtype=torch.int32)
    host = tokens.cpu().numpy()
    return dict(sizes, tree=leaves, tokens=tokens,
                host=[host[i].tobytes() for i in range(len(host))])


def on_cpu(data: dict) -> dict:
    """The same data with its tensors copied to the machine's CPU."""
    return dict(data, tree={k: v.cpu() for k, v in data["tree"].items()},
                tokens=data["tokens"].cpu())


@contextlib.contextmanager
def one_rank_group(dev):
    """A one-rank process group for ``dev`` (NCCL on the card, gloo on the
    CPU) and its (1, 1) storage mesh (``dp``, ``chain``), as phase 9 makes
    one; destroyed on exit."""
    import torch.distributed as dist

    from tpu3fs_torch.parallel import backend_for, make_storage_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend_for(dev),
                            init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    try:
        yield make_storage_mesh(1, device=dev)
    finally:
        dist.destroy_process_group()


def train_run(dev, data: dict, mesh, trace: bool = False,
              digest: bool = False) -> dict:
    """Steps 1-6 of the training phase on a fresh RS(12,4) fabric on
    ``dev``: (1) save step 1, restore it verified and byte-range exact
    onto templates on ``dev``; (2) ``save_async`` step 2 (the stall, then
    the commit); (3) fail the first node, restore step 2 degraded, restart
    it on empty engines and ``resync_all``; (4) keep-last-1 retention;
    (5) pack the records into ``files`` record files (streaming, declared
    count); (6) one shuffled, CRC-verified epoch on ``mesh``, then the
    same epoch cut at ``cut`` steps, its state saved (``StateStore``) and
    resumed. Every restored leaf is held bit for bit against its source
    on ``dev``, every batch's local tensor against its records there.
    With ``trace`` it runs only the requests whose device share is
    reported, each under torch.profiler: step 1's save and verified
    restore, the packing and the epoch (not the byte-range restore,
    steps 2-4 or the resume). Returns the record (manifests, GC, the
    batches' ids; with ``digest`` the stored chunks and the batches'
    sha256), each request's host time (with ``trace`` its device time)
    and the bytes each rate is over."""
    import hashlib

    from tpu3fs_torch.ckpt import CheckpointManager, RetentionPolicy
    from tpu3fs_torch.dataload import (DataLoader, LoaderConfig,
                                       PackedDataset, RecordFileWriter,
                                       StateStore)
    from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
    from tpu3fs_torch.storage.engine import MemChunkEngine
    from torch.distributed.tensor import DTensor, Replicate, Shard

    leaves, tokens = data["tree"], data["tokens"]
    rec, requests, stall = {}, {}, {}

    def request(name, fn):
        return timed_request(requests, name, fn, dev, trace)

    fab = None
    try:
        with deterministic(13, step_clock=True) as clock:
            fab = Fabric(SystemSetupConfig(
                num_storage_nodes=FAB_NODES, num_chains=FAB_CHAINS,
                chunk_size=MIB, ec_k=K, ec_m=M), device=dev)
            mgr = CheckpointManager(fab.meta, fab.file_client(), kv=fab.kv,
                                    clock=clock.time,
                                    policy=RetentionPolicy(keep_last=1))
            like = {k: torch.empty_like(v) for k, v in leaves.items()}

            def restore(name, step, verify=True):
                got = request(name, lambda: mgr.restore(step, like=like,
                                                        verify=verify))
                for k, v in leaves.items():
                    require(got[k].device == v.device and torch.equal(
                        got[k].view(torch.int32), v.view(torch.int32)),
                        f"{name}: leaf {k} differs from its source")

            # 1: a sync save; verified and byte-range-exact restores
            clock.advance()
            rec["manifest_1"] = request("save_sync", lambda: mgr.save(
                leaves, 1)).encode()
            restore("restore_verified", 1)
            lost = 0
            if not trace:
                restore("restore_ranged", 1, verify=False)
                # 2: an async save: the stall until it returns, the commit
                clock.advance()
                handle = request("save_async_stall",
                                 lambda: mgr.save_async(leaves, 2))
                rec["async"] = request("save_async_commit",
                                       lambda: handle.result(600.0))
                rec["manifest_2"] = mgr.manifest(2).encode()
                # 3: the first node fails (m shards of every stripe); step 2
                # restores through decodes; the node restarts empty, resyncs
                clock.advance()
                victim = sorted(fab.nodes)[0]
                lost = sum(t.engine.used_size()
                           for t in fab.nodes[victim].service.targets())
                fab.fail_node(victim)
                restore("restore_degraded", 2)
                for t in fab.nodes[victim].service.targets():
                    t.engine = MemChunkEngine(device=dev)
                fab.restart_node(victim)
                rec["resynced"] = request("resync", lambda: fab.resync_all(
                    rounds=6))
                requests["resync"]["lost_bytes"] = lost
                # 4: keep-last-1 retention: step 1 goes to the trash
                clock.advance()
                rec["gc_removed"] = request("gc_keep_last_1", mgr.run_gc)
                rec["steps"] = mgr.steps()
                require(rec["gc_removed"] == 1 and rec["steps"] == [2],
                        f"retention kept steps {rec['steps']}")
            if digest:
                rec["stored_ckpt"] = fabric_stored(fab)
            # 5: the records packed into record files, streaming
            clock.advance()
            fio = fab.file_client()
            fab.meta.mkdirs("/data", recursive=True)
            per = data["records"] // data["files"]
            paths = [f"/data/tokens{i}.rec" for i in range(data["files"])]

            def pack():
                for i, path in enumerate(paths):
                    w = RecordFileWriter(fab.meta, fio, path,
                                         num_records=per)
                    for r in data["host"][i * per:(i + 1) * per]:
                        w.append(r)
                    w.commit()

            request("pack_records", pack)
            # 6: a shuffled, verified epoch of DTensor batches on the mesh;
            # the epoch again, cut, its state saved, resumed
            ds = PackedDataset(fab.meta, fio, paths)
            cfg = dict(global_batch=data["batch"], seed=5, dtype="<i4",
                       sample_shape=(SEQ_TOKENS,), depth=2, epochs=1)

            def check(b):
                local = b.data.to_local()
                require(isinstance(b.data, DTensor) and tuple(b.data.shape)
                        == (data["batch"], SEQ_TOKENS)
                        and b.data.placements == (Shard(0), Replicate())
                        and local.device == tokens.device and torch.equal(
                            local, tokens[torch.tensor(b.ids,
                                                       device=tokens.device)]),
                        f"batch {b.step}: its tokens differ from the records")
                return (b.epoch, b.step, b.ids,
                        hashlib.sha256(local.cpu().numpy().tobytes())
                        .hexdigest() if digest else None)

            def epoch():
                with DataLoader(ds, LoaderConfig(**cfg), mesh=mesh) as ld:
                    out = [check(b) for b in ld]
                    (stall["epoch"],) = ld._stall_ms.collect(0.0)
                return out

            rec["epoch"] = request("epoch", epoch)
            ids = [i for _, _, b, _ in rec["epoch"] for i in b]
            require(sorted(ids) == list(range(data["records"])),
                    "the epoch did not cover every record once")

            def resume():
                store = StateStore(fab.meta, fio, "/data/loader.state")
                with DataLoader(ds, LoaderConfig(**cfg), mesh=mesh) as ld:
                    head = [check(next(ld)) for _ in range(data["cut"])]
                    store.save(ld.state())
                state = store.load()
                with DataLoader(ds, LoaderConfig(**cfg), mesh=mesh,
                                state=state) as ld:
                    tail = [check(b) for b in ld]
                return head, tail, state.encode()

            if not trace:
                head, tail, rec["state"] = request("epoch_resume", resume)
                require(head + tail == rec["epoch"],
                        "the resumed loader did not yield the exact "
                        "remaining batches")
            if digest:
                rec["stored"] = fabric_stored(fab)
        ckpt_bytes = sum(v.numel() * v.element_size() for v in leaves.values())
        return {"record": rec, "requests": requests, "stall": stall,
                "bytes": {"ckpt": ckpt_bytes, "lost": lost,
                          "records": data["records"] * SEQ_TOKENS * 4}}
    finally:
        if fab is not None:
            for node in fab.nodes.values():
                node.service.stop_workers()


def train(dev):
    """Checkpoints and data loading on the card: the sequence at small
    depth on the card (also the warm-up), then at full size (the main
    path), then at small depth on the CPU, whose record must equal the
    card's. Returns the main run's launch counts, the run and the data
    for ``train_shares``."""
    t0 = phase("phase 13: checkpoints and training data loading")
    full = train_data(dev, TRAIN_FULL)
    small = train_data(dev, TRAIN_SMALL)
    with one_rank_group(dev) as mesh:
        card_small = train_run(dev, small, mesh, digest=True)
        zero_counts()
        card = train_run(dev, full, mesh)
        counts = read_counts()
    require_main_path("checkpoints and data loading", counts,
                      ("gf2_matmul", "crc32c_blocks"))
    cpu_dev = torch.device("cpu")
    t_cpu = time.perf_counter()
    with one_rank_group(cpu_dev) as mesh:
        cpu = train_run(cpu_dev, on_cpu(small), mesh, digest=True)
    card["cpu_route_s"] = time.perf_counter() - t_cpu
    for key, got in cpu["record"].items():
        require(got == card_small["record"][key],
                f"the CPU run's {key} differs from the card's")
    req, nbytes = card["requests"], card["bytes"]
    gib = lambda n, ms: n / (1 << 30) / (ms / 1e3)  # noqa: E731
    ck = nbytes["ckpt"]
    stall = card["stall"]["epoch"]
    card["e2e"] = {
        "save_GiB_s": gib(ck, req["save_sync"]["host_ms"]),
        "restore_verified_GiB_s": gib(ck, req["restore_verified"]["host_ms"]),
        "restore_ranged_GiB_s": gib(ck, req["restore_ranged"]["host_ms"]),
        "restore_degraded_GiB_s": gib(ck, req["restore_degraded"]["host_ms"]),
        "async_commit_GiB_s": gib(ck, req["save_async_commit"]["host_ms"]),
        "async_stall_ms": req["save_async_stall"]["host_ms"],
        "rebuild_MiB_s": nbytes["lost"] / MIB
        / (req["resync"]["host_ms"] / 1e3),
        "pack_GiB_s": gib(nbytes["records"], req["pack_records"]["host_ms"]),
        "loader_samples_s": TRAIN_FULL["records"]
        / (req["epoch"]["host_ms"] / 1e3),
        "loader_GiB_s": gib(nbytes["records"], req["epoch"]["host_ms"]),
        "dataload_stall_ms": {k: getattr(stall, k) for k in (
            "count", "mean", "p50", "p99", "max", "value")},
    }
    log(f"train: launches {counts}, e2e {json.dumps(card['e2e'])}, CPU "
        f"route {card['cpu_route_s']:.1f} s ({time.perf_counter() - t0:.1f} s)")
    return counts, card, full


def train_shares(dev, run: dict, data: dict) -> None:
    """The full-size save, verified restore, packing and epoch again on
    the card, each under torch.profiler for its device time; logs each
    request's host time and launches from the main path's run beside the
    traced run's host and device times (none for the requests the traced
    run leaves out). Runs after phase 15's traces, as ``storage_shares``
    does."""
    t0 = phase("phase 13 (continued): the training requests' device time")
    with one_rank_group(dev) as mesh:
        traced = train_run(dev, data, mesh, trace=True)
    for key, got in traced["record"].items():
        require(got == run["record"][key],
                f"the traced card run's {key} differs from the main path's")
    rows = {name: dict(row, traced=traced["requests"].get(name, {}))
            for name, row in run["requests"].items()}
    log(json.dumps({"train_requests": rows, "e2e": run["e2e"],
                    "card": card_line(), "cpu_route_s": run["cpu_route_s"],
                    "shapes": "one Llama-3.1-8B decoder layer, float32, 9 "
                              "leaves, 872,448,000 B; 4,096 records of "
                              "8,192 int32 tokens in 4 files, global batch "
                              "64, depth 2; RS(12,4) over 4 nodes and 2 "
                              "chains, 1 MiB chunks"}))
    for name, row in rows.items():
        tr = row["traced"]
        shares = (f"traced host {tr['host_ms']:10.3f} ms, share "
                  f"{tr['device_share']:.4f}" if tr else "not traced")
        log(f"  {name:<20} host {row['host_ms']:10.3f} ms  K1 "
            f"{row['launches'].get('gf2_matmul', 0):5d} K2 "
            f"{row['launches'].get('crc32c_blocks', 0):6d} K3 "
            f"{row['launches'].get('xor_reduce', 0):3d}  {shares}")
    log(f"train shares ({time.perf_counter() - t0:.1f} s)")


# -- phase 14 ----------------------------------------------------------------
def incidence_of_lines(lines, nodes: int) -> np.ndarray:
    """The (chains, nodes) incidence that a command file lays: its
    create-target lines name each chain's member nodes (node ids 10 + i)."""
    members = {}
    for line in lines:
        if line.startswith("create-target "):
            f = line.split()
            chain = int(f[f.index("--chain-id") + 1])
            members.setdefault(chain, []).append(
                int(f[f.index("--node-id") + 1]) - 10)
    M = np.zeros((len(members), nodes), dtype=np.int8)
    for g, chain in enumerate(sorted(members)):
        M[g, members[chain]] = 1
    return M


def device_time_per_step(dev, problem, steps: int, host_ms_per_step: float):
    """Device time of one annealing step by kind (the swap kernels, the
    copies), from a torch.profiler trace of a ``steps``-step solve, and the
    share of the main-path run's step time the device is busy. The trace
    also holds the solve's set-up copies (the table, its Gram), so the
    copies' time a step is an upper bound. None where the profiler sees
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    from tpu3fs_torch.placement import solve_placement

    from torch.autograd import DeviceType

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve_placement(problem, steps=steps, device=dev)
        torch.cuda.synchronize()
    by_kind = {"swap_score_kernel": 0.0, "swap_apply_kernel": 0.0,
               "memcpy": 0.0, "other": 0.0}
    for e in prof.profiler.kineto_results.events():  # the device's own
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()
        kind = next((k for k in by_kind if k in name), None)
        if kind is None:
            kind = "memcpy" if "memcpy" in name.lower() else "other"
        by_kind[kind] += (e.end_ns() - e.start_ns()) / 1e6 / steps
    busy = sum(by_kind.values())
    if busy == 0:
        return None
    return {"ms_per_step": by_kind, "busy_ms_per_step": busy,
            "steps_traced": steps,
            "device_busy_share": busy / host_ms_per_step}


def placement(dev, cmp: Compare) -> dict:
    """The CR and EC chain tables through entry.gen_chain_table, each
    checked and held against the full-Gram route's run of the same seed;
    the card's state against the final table; one CR step's split on both
    routes. Returns the two main-path runs' launch counts, summed."""
    from unittest import mock

    import tpu3fs_torch.placement.solver as solver
    from tpu3fs_torch.entry import gen_chain_table
    from tpu3fs_torch.ops.placement_score import score_batch
    from tpu3fs_torch.ops.swap_score import (swap_apply, swap_score,
                                             swap_state)
    from tpu3fs_torch.placement import PlacementProblem, check_solution

    t0 = phase("phase 14: chain-table placement through entry.gen_chain_table")
    racks = [f"rack{i * RACKS // PLACE_NODES}" for i in range(PLACE_NODES)]
    tables = {
        "cr": (CR_WIDTH, CR_TARGETS, dict(steps=PLACE_STEPS),
               dict(chain_table_type="CR")),
        "ec": (EC_K + EC_M, EC_TARGETS,
               dict(steps=PLACE_STEPS, ec_k=EC_K, ec_m=EC_M, domains=racks,
                    max_per_domain=EC_M),
               dict(chain_table_type="EC", domains=racks,
                    max_per_domain=EC_M)),
    }

    def full_gram_route(name, width, targets, gen, dom_t, cap):
        """The same solve with each step's proposals materialised on the
        host, copied in whole and scored by score_batch (the port's route
        before the swap scorer); the first CHECKED_STEPS steps also score
        the moves with the swap kernel, which must agree."""
        step = {"n": 0}
        real_moves = solver._propose_moves

        def propose_moves(M, rng, P):
            moves = real_moves(M, rng, P)
            step["M"], step["moves"] = M, moves  # the solver's host table
            return moves

        def score(state, moves_dev):
            cand = solver._materialise(step["M"], step["moves"])
            full = torch.stack(score_batch(torch.from_numpy(cand).to(dev),
                                           dom_t, cap))
            if step["n"] < CHECKED_STEPS:
                cmp(swap_score(state, moves_dev), full,
                    f"{name} step {step['n']}: swap kernel vs score_batch")
            step["n"] += 1
            return full

        with mock.patch.object(solver, "_propose_moves", propose_moves), \
                mock.patch.object(solver, "swap_score", score):
            t = time.perf_counter()
            lines = gen_chain_table(PLACE_NODES, width, targets, device=dev,
                                    **gen)
            torch.cuda.synchronize()
        return lines, time.perf_counter() - t, step["n"]

    total, out = {}, {}
    for name, (width, targets, gen, prob) in tables.items():
        problem = PlacementProblem(num_nodes=PLACE_NODES, group_size=width,
                                   targets_per_node=targets, **prob)
        labels = solver._domain_index(problem)
        cap = EC_M if labels is not None else 0
        states = []

        def keep_state(*args, **kw):
            states.append(swap_state(*args, **kw))
            return states[-1]

        zero_counts()
        with mock.patch.object(solver, "swap_state", keep_state):
            t = time.perf_counter()
            lines = gen_chain_table(PLACE_NODES, width, targets, device=dev,
                                    **gen)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t
        counts = read_counts()
        require_main_path(f"the {name} placement", counts,
                          ("swap_score", "swap_apply"))
        total = {n: total.get(n, 0) + c for n, c in counts.items()}
        steps = counts["swap_score"]
        M = incidence_of_lines(lines, PLACE_NODES)
        require(check_solution(M, problem),
                f"{name}: the table fails check_solution")
        # the card's state after the run is the final table's
        state = states[0]
        Mf = torch.from_numpy(M).to(dev).to(torch.float32)
        gram = (Mf.T @ Mf).to(torch.int32)
        gram.fill_diagonal_(0)
        cmp(state.G, gram, f"{name}: the card's G against M^T M")
        cmp(state.M, torch.from_numpy(M).to(dev), f"{name}: the card's M")
        fresh = state_parts(swap_state(M, labels, cap, dev))
        for part, want in state_parts(state).items():
            cmp(want, fresh[part], f"{name}: the card's {part}, fresh build")

        dom_t = None if labels is None else torch.from_numpy(labels).to(dev)
        ref, ref_s, ref_steps = full_gram_route(name, width, targets, gen,
                                                dom_t, cap)
        require(lines == ref, f"{name}: the table differs from the full-Gram "
                "route's run of the same seed")
        require(ref_steps == steps, f"{name}: {steps} steps, the full-Gram "
                f"route {ref_steps}")
        greedy = solver._greedy_incidence(problem)
        out[name] = {
            "chains": len(M), "nodes": PLACE_NODES, "width": width,
            "targets_per_node": targets, "command_lines": len(lines),
            "steps": steps, "accepted": counts["swap_apply"],
            "lambda_max": solver._score_np(M)[0],
            "greedy_lambda_max": solver._score_np(greedy)[0],
            "lambda_lower_bound": problem.lambda_lower_bound,
            "domain_overflow": solver.domain_overflow(M, problem),
            "greedy_domain_overflow": solver.domain_overflow(greedy, problem),
            "host_s": run_s, "host_ms_per_step": run_s * 1e3 / max(steps, 1),
            "full_gram_route_host_s": ref_s,
            "full_gram_route_host_ms_per_step": ref_s * 1e3 / max(steps, 1),
            "steps_checked_against_score_batch": min(steps, CHECKED_STEPS)}

    # one CR step's split on each route (host clock, each part ending in a
    # synchronise; the kernels also by events); the first of 6 steps is
    # dropped and the median of the other 5 kept. The swap route stages
    # its moves and scores in pinned memory, as the solver does; the
    # pageable copies are timed beside them
    problem = PlacementProblem(num_nodes=PLACE_NODES, group_size=CR_WIDTH,
                               targets_per_node=CR_TARGETS)
    M = solver._greedy_incidence(problem)
    state = swap_state(M, None, 0, dev)
    rng = np.random.default_rng(1)
    moves_host = torch.empty((5, 128), dtype=torch.int32, pin_memory=True)
    scores_host = torch.empty((3, 128), dtype=torch.int32, pin_memory=True)
    swap_parts = {"draws_ms": [], "copy_in_ms": [], "swap_kernel_ms": [],
                  "swap_kernel_event_ms": [], "copy_back_ms": [],
                  "apply_ms": [], "step_ms": [], "copy_in_pageable_ms": [],
                  "copy_back_pageable_ms": []}
    full_parts = {"propose_ms": [], "copy_in_ms": [], "score_batch_ms": [],
                  "score_batch_event_ms": [], "copy_back_ms": [],
                  "step_ms": []}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    stream = torch.cuda.current_stream(dev)
    for _ in range(6):
        t = time.perf_counter()
        moves = solver._propose_moves(M, rng, 128)
        moves_host.numpy()[:] = np.stack(moves)
        t1 = time.perf_counter()
        mt = moves_host.to(dev, non_blocking=True)
        stream.synchronize()
        t2 = time.perf_counter()
        ev[0].record()
        scores = swap_score(state, mt)
        ev[1].record()
        stream.synchronize()
        t3 = time.perf_counter()
        scores_host.copy_(scores, non_blocking=True)
        stream.synchronize()
        overs, maxs, ssqs = scores_host.numpy()
        t4 = time.perf_counter()
        p = int(np.lexsort((ssqs, maxs, overs))[0])
        swap_apply(state, mt, p)
        stream.synchronize()
        t5 = time.perf_counter()
        if moves.valid[p]:
            g1, g2, a, c = (int(x[p]) for x in moves[:4])
            M[g1, a], M[g1, c], M[g2, c], M[g2, a] = 0, 1, 0, 1
        packed = moves_host.numpy().copy()
        t6 = time.perf_counter()
        torch.from_numpy(packed).to(dev)
        stream.synchronize()
        t7 = time.perf_counter()
        scores.cpu()
        t8 = time.perf_counter()
        for part, ms in zip(swap_parts, (
                (t1 - t) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                ev[0].elapsed_time(ev[1]), (t4 - t3) * 1e3, (t5 - t4) * 1e3,
                (t5 - t) * 1e3, (t7 - t6) * 1e3, (t8 - t7) * 1e3)):
            swap_parts[part].append(ms)

        t = time.perf_counter()
        cand = solver._propose(M, rng, 128)
        t1 = time.perf_counter()
        x = torch.from_numpy(cand).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ev[0].record()
        full = score_batch(x)
        ev[1].record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        torch.stack(full).cpu().numpy()
        t4 = time.perf_counter()
        for part, ms in zip(full_parts, (
                (t1 - t) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3,
                ev[0].elapsed_time(ev[1]), (t4 - t3) * 1e3, (t4 - t) * 1e3)):
            full_parts[part].append(ms)
    # the step's two copies staged in pinned and in pageable memory, in
    # turns (pageable, pinned, pinned, pageable), 50 copies each, host clock
    def copy_ms(copy):
        copy()
        stream.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            copy()
            stream.synchronize()
        return (time.perf_counter() - t) * 1e3 / 50

    copies = {
        "in_pageable": lambda: torch.from_numpy(packed).to(dev),
        "in_pinned": lambda: moves_host.to(dev, non_blocking=True),
        "back_pageable": lambda: scores.cpu(),
        "back_pinned": lambda: scores_host.copy_(scores, non_blocking=True)}
    copy_turns = {name: [] for name in copies}
    for order in (0, 1, 1, 0):
        for way in ("in", "back"):
            kinds = ("pageable", "pinned") if order == 0 else ("pinned",
                                                                "pageable")
            for kind in kinds:
                copy_turns[f"{way}_{kind}"].append(
                    copy_ms(copies[f"{way}_{kind}"]))
    median = lambda runs: sorted(runs[1:])[len(runs[1:]) // 2]  # noqa: E731
    out["cr_step_split"] = {part: median(v) for part, v in swap_parts.items()}
    out["cr_step_split"]["moves_bytes"] = int(packed.nbytes)
    out["cr_copy_turns_ms"] = copy_turns
    out["cr_step_split_full_gram"] = {part: median(v)
                                      for part, v in full_parts.items()}
    out["cr_step_split_full_gram"]["proposals_bytes"] = int(cand.nbytes)
    out["cr_device_time"] = device_time_per_step(dev, problem, 40,
                                                 out["cr"]["host_ms_per_step"])
    log(json.dumps({"placement": out}))
    log(f"placement: CR {out['cr']['steps']} steps, λ {out['cr']['lambda_max']}"
        f" (greedy {out['cr']['greedy_lambda_max']}, lower bound "
        f"{out['cr']['lambda_lower_bound']}); EC {out['ec']['steps']} steps, "
        f"λ {out['ec']['lambda_max']} (greedy "
        f"{out['ec']['greedy_lambda_max']}, lower bound "
        f"{out['ec']['lambda_lower_bound']}), overflow "
        f"{out['ec']['domain_overflow']}; {cmp.cases} comparisons equal; "
        f"launches {total} ({time.perf_counter() - t0:.1f} s)")
    return total


# -- phase 15 ----------------------------------------------------------------
def mma_rates(dev) -> dict:
    """Issue rate of the two mma forms on register operands, every SM busy
    (csrc/mma_rate.cu): the card's data sheet has no 1-bit rate."""
    from tpu3fs_torch import kernels

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    blocks, iters = 8 * sms, 512
    rates = {}
    for kind, name, ops in ((0, "b1_m16n8k256", 2 * 16 * 8 * 256),
                            (1, "s8_m16n8k32", 2 * 16 * 8 * 32)):
        def launch(kind=kind):
            kernels.launch("tpu3fs_mma_rate", dev, kind, blocks, iters, out)
        ms = cuda_ms(launch, 5)
        per_s = blocks * 8 * iters * 8 / (ms / 1e3)
        rates[name] = {"ms": ms, "mma_per_s_per_sm": per_s / sms,
                       "dense_TOP_s": per_s * ops / 1e12}
    return rates


def fold_trace(fold, batches, calls: int = 30, path=None) -> dict:
    """A torch.profiler trace of one CUDA graph of ``calls`` fold calls,
    each on the next of ``batches``: the device operations of one call by
    name (kernels, memsets), their mean durations, the mean gap between
    one device operation's end and the next one's start, and the graph's
    span per call. ``path``: where the Chrome trace is written."""
    from torch.profiler import ProfilerActivity, profile

    cycle = itertools.cycle(batches)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fold(next(cycle))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fold(next(cycle))
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    out = Path(path or OUT_DIR / "fold_trace.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out))
    events = sorted((e for e in json.loads(out.read_text())["traceEvents"]
                     if e.get("ph") == "X" and e.get("cat") in
                     ("kernel", "gpu_memset", "gpu_memcpy")),
                    key=lambda e: e["ts"])
    if not events:
        return {"device_ops": 0, "note": "the profiler saw no device time"}
    by_name = {}
    for e in events:
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        d = by_name.setdefault(name, {"count": 0, "us": 0.0})
        d["count"] += 1
        d["us"] += e["dur"]
    for d in by_name.values():
        d["mean_us"] = d.pop("us") / d["count"]
        d["per_call"] = d.pop("count") / calls
    gaps = [b["ts"] - (a["ts"] + a["dur"]) for a, b in zip(events, events[1:])]
    return {"device_ops_per_call": len(events) / calls, "by_name": by_name,
            "gap_mean_us": sum(gaps) / len(gaps) if gaps else 0.0,
            "gap_max_us": max(gaps) if gaps else 0.0,
            "span_us_per_call": (events[-1]["ts"] + events[-1]["dur"]
                                 - events[0]["ts"]) / calls,
            "calls": calls, "trace": str(out)}


def fold_split(dev, folds: dict) -> dict:
    """Each fold in ``folds`` (name -> function) at the chain write's
    12 x 1 MiB (6 batches, 75 MB, over the L2) and the dry run's 2 x 128:
    a traced CUDA graph of 30 calls (``fold_trace``), its time by events,
    and the eager wrapper's time by events."""
    out = {}
    for shape, n in (((B_WRITE, S_WRITE), 6), ((2, 128), 1)):
        batches = [rand_u8(shape, 90 + i, dev) for i in range(n)]
        for name, fold in folds.items():
            cycle = itertools.cycle(batches)
            key = f"{name} {shape[0]}x{shape[1]}"
            out[key] = {
                "trace": fold_trace(fold, batches, path=(
                    OUT_DIR / f"fold_trace_{name}_{shape[0]}x{shape[1]}"
                    ".json")),
                "graph_ms": graph_ms(lambda: fold(next(cycle)), 30),
                "eager_ms": cuda_ms(lambda: fold(next(cycle)), 30)}
    return out


def turns(old, new, timer=cuda_ms):
    """The earlier kernel and the new one in turns: old, new, new, old."""
    t = [timer(old, 30), timer(new, 30), timer(new, 30), timer(old, 30)]
    return {"new_ms": [t[1], t[2]], "old_ms": [t[0], t[3]],
            "new": (t[1] + t[2]) / 2, "old": (t[0] + t[3]) / 2}


def k4_times(dev) -> dict:
    """K4 at every shape of FOLD_SHAPES: the atomic kernel (old) and the new one
    in turns, replayed from CUDA graphs and eagerly, each call on the next
    of enough batches to touch over 50 MB, so each reads from HBM (one
    batch at the dry run's shape: launch cost only); the plain version from
    a graph; the bytes bound; the plan's route. Then both kernels' device
    operations in a traced graph (``fold_split``): the new kernel must be
    one kernel a call and no memset."""
    from tpu3fs_torch.ops.xor_fold import (fold_plan, xor_fold_crc,
                                           xor_fold_crc_atomic,
                                           xor_fold_crc_plain)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {}
    for batch, size, offset, why in FOLD_SHAPES:
        nbytes = batch * size
        n = 1 if nbytes < MIB else max(2, -(-75_000_000 // nbytes))
        batches = [fold_input((batch, size), offset, 300 + i, dev)
                   for i in range(n)]
        cyc = itertools.cycle(batches)

        def old():
            return xor_fold_crc_atomic(next(cyc))

        def new():
            return xor_fold_crc(next(cyc))
        shapes[f"{batch}x{size}+{offset}"] = {
            "why": why, "batches": n,
            "route": fold_plan(batch, size, sms)._asdict(),
            "graph_turns_ms": turns(old, new, graph_ms),
            "eager_turns_ms": turns(old, new),
            "plain_graph_ms": graph_ms(lambda: xor_fold_crc_plain(next(cyc)),
                                       10),
            "bound_ms": (nbytes + 4 * batch) / HBM_BYTES_PER_S * 1e3}
        del batches, cyc
        torch.cuda.empty_cache()
    split = fold_split(dev, {"atomic": xor_fold_crc_atomic,
                             "new": xor_fold_crc})
    for key, got in split.items():
        if key.startswith("new"):
            trace = got["trace"]
            require(trace.get("device_ops_per_call") == 1.0
                    and "gpu_memset" not in trace["by_name"],
                    f"K4 {key}: a traced graph call is not one kernel: "
                    f"{trace}")
    return {"shapes": shapes, "split": split}


def k5_times(dev) -> dict:
    """K5's kernels on one annealing step at the placement runs' shapes,
    beside their bounds."""
    from tpu3fs_torch.ops.placement_score import score_batch, score_batch_plain
    from tpu3fs_torch.ops.swap_score import (gram_np, swap_apply,
                                             swap_apply_plain, swap_score,
                                             swap_score_plain, swap_state)
    from tpu3fs_torch.placement import PlacementProblem, solver

    # K5 on one annealing step: the full-Gram kernel on the materialised
    # proposals, the CR table's (128, 5760, 180) and the EC table's
    # (128, 180, 180) with its 18 racks, and the swap kernel on the same
    # step's moves and state, in turns; each eagerly (the host's enqueue
    # shows) and the swap kernels also replayed from a CUDA graph
    cr = PlacementProblem(num_nodes=PLACE_NODES, group_size=CR_WIDTH,
                          targets_per_node=CR_TARGETS)
    rng = np.random.default_rng(3)
    cr_table = solver._greedy_incidence(cr)
    cr_moves = solver._propose_moves(cr_table, rng, 128)
    cand = torch.from_numpy(solver._materialise(cr_table, cr_moves)).to(dev)
    cr_state = swap_state(cr_table, None, 0, dev)
    cr_mt = moves_on(cr_moves, dev)
    k5t = turns(lambda: score_batch_plain(cand), lambda: score_batch(cand))
    swapt = turns(lambda: score_batch(cand), lambda: swap_score(cr_state, cr_mt))
    swap_graph = graph_ms(lambda: swap_score(cr_state, cr_mt), 100)
    swap_plain = cuda_ms(lambda: swap_score_plain(cr_state, cr_mt), 10)
    racks = [f"rack{i * RACKS // PLACE_NODES}" for i in range(PLACE_NODES)]
    ec = PlacementProblem(num_nodes=PLACE_NODES, group_size=EC_K + EC_M,
                          targets_per_node=EC_TARGETS, chain_table_type="EC",
                          domains=racks, max_per_domain=EC_M)
    ec_table = solver._greedy_incidence(ec)
    ec_moves = solver._propose_moves(ec_table, rng, 128)
    ec_cand = torch.from_numpy(solver._materialise(ec_table, ec_moves)).to(dev)
    ec_labels = solver._domain_index(ec)
    ec_dom = torch.from_numpy(ec_labels).to(dev)
    ec_state = swap_state(ec_table, ec_labels, EC_M, dev)
    ec_mt = moves_on(ec_moves, dev)
    k5_ec = turns(lambda: score_batch_plain(ec_cand, ec_dom, EC_M),
                  lambda: score_batch(ec_cand, ec_dom, EC_M))
    swap_ec = turns(lambda: score_batch(ec_cand, ec_dom, EC_M),
                    lambda: swap_score(ec_state, ec_mt))
    swap_ec_graph = graph_ms(lambda: swap_score(ec_state, ec_mt), 100)
    # the apply kernel on the CR state: a valid move and its reverse in
    # turns, so the state comes back after every pair
    p = int(np.argmax(cr_moves.valid))
    g1, g2, a, c = (int(x[p]) for x in cr_moves[:4])
    pair = torch.tensor([[g1, g1], [g2, g2], [a, c], [c, a], [1, 1]],
                        dtype=torch.int32, device=dev)

    def apply_pair(apply=swap_apply):
        apply(cr_state, pair, 0)
        apply(cr_state, pair, 1)
    apply_eager = cuda_ms(apply_pair, 30) / 2
    apply_graph = graph_ms(apply_pair, 50) / 2
    apply_plain = cuda_ms(lambda: apply_pair(swap_apply_plain), 10) / 2
    fresh = state_parts(swap_state(cr_table, None, 0, dev))
    for part, got in state_parts(cr_state).items():
        require(torch.equal(got, fresh[part]),
                f"the timed apply pairs left the CR state's {part} changed")
    changed = int((cr_table[g1] != cr_table[g2]).sum()) - 2  # d != 0 off a, c
    P5, b5, v5 = cand.shape
    k5_bound, k5_by = bound_ms(cand.numel() + 3 * 4 * P5, 2 * P5 * b5 * v5 * v5)
    Pe, be, ve = ec_cand.shape
    k5_ec_bound, k5_ec_by = bound_ms(ec_cand.numel() + 4 * ve + 3 * 4 * Pe,
                                     2 * Pe * be * ve * ve)

    def swap_bytes(moves, v, domains):
        """What one swap_score call must move for these moves: the distinct
        rows of M and of G they name, the moves, the scores, the state and
        hist[max], and with domains 2 domain labels and 4 counts a move."""
        val = moves.valid
        P = len(val)
        m_rows = np.unique(np.r_[moves.g1[val], moves.g2[val]]).size
        g_rows = np.unique(np.r_[moves.a[val], moves.c[val]]).size
        return (m_rows * v + g_rows * 4 * v + 20 * P + 12 * P + 24 + 4
                + (24 * int(val.sum()) if domains else 0))
    swap_bound, swap_by = bound_ms(swap_bytes(cr_moves, v5, False), 0)
    swap_no_reuse = P5 * 10 * v5 / HBM_BYTES_PER_S * 1e3  # 2 + 8 v a move
    swap_ec_bound, _ = bound_ms(swap_bytes(ec_moves, ve, True), 0)
    # the apply: rows g1 and g2 of M read, G read and written at each node
    # whose pair changes (4 words), the hist bins they leave and reach, 4
    # entries of M, the move and the state
    gram = gram_np(cr_table)
    x = np.setdiff1d(np.flatnonzero(cr_table[g1] != cr_table[g2]), [a, c])
    d = cr_table[g2, x].astype(np.int64) - cr_table[g1, x]
    bins = np.unique(np.r_[gram[a, x], gram[c, x], gram[a, x] + d,
                           gram[c, x] - d])
    apply_bound, apply_by = bound_ms(
        2 * v5 + 8 * x.size + 16 * x.size + 8 * bins.size + 4 + 20 + 48, 0)
    return {
        "score_cr_turns_ms": k5t, "score_cr_bound_ms": k5_bound,
        "score_cr_bound_by": k5_by,
        "score_cr_GB_s": cand.numel() / 1e9 / (k5t["new"] / 1e3),
        "score_ec_turns_ms": k5_ec, "score_ec_bound_ms": k5_ec_bound,
        "score_ec_bound_by": k5_ec_by,
        "swap_cr_turns_ms": swapt, "swap_cr_graph_ms": swap_graph,
        "swap_cr_plain_ms": swap_plain, "swap_cr_bound_ms": swap_bound,
        "swap_cr_bound_by": swap_by,
        "swap_cr_bound_no_reuse_ms": swap_no_reuse,
        "swap_ec_turns_ms": swap_ec, "swap_ec_graph_ms": swap_ec_graph,
        "swap_ec_bound_ms": swap_ec_bound,
        "apply_eager_ms": apply_eager, "apply_graph_ms": apply_graph,
        "apply_plain_ms": apply_plain, "apply_bound_ms": apply_bound,
        "apply_bound_by": apply_by, "apply_changed_pairs": 2 * int(x.size),
        "shapes": "score_batch on one step's materialised proposals, "
                  "(128, 5760, 180) CR and (128, 180, 180) EC with 18 "
                  "racks; swap_score on the same steps' 128 moves against "
                  "the greedy table's state; swap_apply one CR move and its "
                  "reverse in turns (ms per apply); swap turns: score_batch "
                  "(old) and swap_score (new)",
    }


def times(dev, paths: dict, cmps: dict):
    from tpu3fs_torch.ops.gf256 import GF
    from tpu3fs_torch.ops.gf2_matmul import (gf2_matmul, gf2_matmul_bitslice,
                                             gf2_matmul_plain, prepare_matrix)
    from tpu3fs_torch.ops.crc32c import BatchCrc32c, crc32c_blocks_table
    from tpu3fs_torch.ops.rs import RSCode
    from tpu3fs_torch.ops.stripe import StripeCodec
    from tpu3fs_torch.ops.xor_reduce import xor_reduce, xor_reduce_plain

    phase("phase 15: times (CUDA events, after warm-up)")
    rs = RSCode(K, M, device=dev)
    B, S = B_WRITE, S_WRITE
    data = rand_u8((B, K, S), 11, dev)
    crc = BatchCrc32c(S, 512, device=dev)
    rows = rand_u8((B * (K + M), S), 12, dev)

    enc = turns(lambda: gf2_matmul_bitslice(rs._parity_cols, data),
                lambda: gf2_matmul(rs._parity_cols, data))
    crct = turns(lambda: crc32c_blocks_table(rows, crc._ks_cols, 512, crc._const),
                 lambda: crc(rows))
    enc_plain = cuda_ms(lambda: gf2_matmul_plain(rs._parity_cols, data), 3, 1)
    crc_plain = cuda_ms(lambda: crc.compute(rows), 3, 1)
    lost = (0, 5, 12, 15)
    present = [i for i in range(K + M) if i not in lost]
    dec_cols = prepare_matrix(GF.expand_to_bits(
        rs._reconstruct_matrix(tuple(present), lost)), dev)
    dec_ms = cuda_ms(lambda: gf2_matmul(dec_cols, data), 30)
    dec_old_ms = cuda_ms(lambda: gf2_matmul_bitslice(dec_cols, data), 30)
    one_cols = prepare_matrix(GF.expand_to_bits(
        rs._reconstruct_matrix(tuple(range(1, K + 1)), (0,))), dev)
    dec1_ms = cuda_ms(lambda: gf2_matmul(one_cols, data), 30)
    xort = turns(lambda: xor_reduce_plain(data), lambda: xor_reduce(data))
    # the chain-encode hop's K1 shape (k = 1, o = 4): both kernels in turns
    hop_cols = rs._delta_col(5)[1]
    hop_data = rand_u8((B, 1, S), 14, dev)
    hopt = turns(lambda: gf2_matmul_bitslice(hop_cols, hop_data),
                 lambda: gf2_matmul(hop_cols, hop_data))
    cdata = rand_u8((1, K, S_CHUNK), 13, dev)
    chunk_ms = cuda_ms(lambda: gf2_matmul(rs._parity_cols, cdata), 50)
    # K4 at every shape of FOLD_SHAPES, the atomic kernel and the new one in
    # turns, from CUDA graphs (the host enqueues a call more slowly than the
    # card runs it) and eagerly; the traced split of both
    k4 = k4_times(dev)
    log(json.dumps({"fold_kernels": k4}))
    fold = k4["shapes"][f"{B}x{S}+0"]
    foldt = fold["graph_turns_ms"]
    k5 = k5_times(dev)
    log(json.dumps({"placement_kernels": k5}))
    rates = mma_rates(dev)

    # where one write request's time goes: host->device copy of the numpy
    # stripes, the device work (K1, concatenation, K2), device->host copy
    codec = StripeCodec(K, M, S, device=dev)
    host = np.random.default_rng(6).integers(0, 256, (B, K, S), dtype=np.uint8)
    for _ in range(2):  # the second pass is the one kept (warm allocator)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        x = torch.from_numpy(host).to(dev)
        ev[1].record()
        shards, crcs = codec.encode_batch(x)
        ev[2].record()
        shards.cpu(), crcs.view(torch.int32).cpu()
        ev[3].record()
        ev[3].synchronize()
    write_ms = {part: ev[i].elapsed_time(ev[i + 1]) for i, part in
                enumerate(["host_to_device", "encode_and_crc", "device_to_host"])}

    gib = lambda nbytes, ms: nbytes / (1 << 30) / (ms / 1e3)  # noqa: E731
    k1_bytes = B * K * S + B * M * S + M * K * 8
    k1_bound, k1_by = bound_ms(k1_bytes, 2 * (8 * M) * (8 * K) * B * S)
    nrows, nblk = B * (K + M), S // 512
    k2_bytes = nrows * S + nrows * 4 + nblk * 32 * 4
    k2_bound, k2_by = bound_ms(
        k2_bytes, nrows * (2 * 8 * S * 32 + 2 * nblk * 32 * 32))
    xor_bound = (B * K * S + B * S) / HBM_BYTES_PER_S * 1e3
    log(json.dumps({
        "encode_GiB_s": gib(B * K * S, enc["new"]),
        "encode_bitslice_GiB_s": gib(B * K * S, enc["old"]),
        "encode_turns_ms": enc, "crc_turns_ms": crct,
        "decode_4_loss_GiB_s": gib(B * K * S, dec_ms), "decode_4_loss_ms": dec_ms,
        "decode_4_loss_bitslice_ms": dec_old_ms, "decode_1_loss_ms": dec1_ms,
        "crc_GiB_s": gib(nrows * S, crct["new"]),
        "crc_table_GiB_s": gib(nrows * S, crct["old"]),
        "xor_rebuild_GiB_s": gib(B * K * S, xort["new"]),
        "xor_rebuild_plain_GiB_s": gib(B * K * S, xort["old"]),
        "xor_turns_ms": xort,
        "encode_4MiB_chunk_ms": chunk_ms,
        "delta_k1_turns_ms": hopt,
        "write_request_ms": write_ms, "mma_rates": rates,
        "shapes": "RS(12,4), B=12 stripes, S=1 MiB; CRC over 192 shards of "
                  "1 MiB, block 512; chunk S=349,696; fold 12 x 1 MiB",
    }))

    def record(name, variant, source, replaces, cmp, ms, earlier_ms, plain,
               bound, by, note=NO_LIBRARY):
        """``earlier_ms``: the integer-unit kernel in the same run (K1, K2),
        the plain torch version that K3 was before it had a kernel, the
        atomic kernel for K4, the full-Gram kernel on the same step for the swap
        scorer; None for score_batch, swap_apply and the atomic K4, which the
        port had in no earlier form."""
        by_path = {path: counts[name] for path, counts in paths.items()}
        return {"name": name, "variant": variant, "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "equal_to_plain": cmp.max_abs_err == 0,
                "max_abs_err": cmp.max_abs_err, "ms": ms, "pr1_ms": earlier_ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "library_ms": None, "library_note": note}

    k1 = ("tpu3fs_torch/csrc/gf2_matmul.cu", "tpu3fs/ops/pallas_rs.py:68")
    k2 = ("tpu3fs_torch/csrc/crc32c.cu", "tpu3fs/ops/crc32c.py:242")
    k3 = ("tpu3fs_torch/csrc/xor_reduce.cu", "tpu3fs/ops/rs.py:42")
    k4_src = ("tpu3fs_torch/csrc/xor_fold.cu", "tpu3fs/parallel/chain.py:30")
    k5_src = ("tpu3fs_torch/csrc/placement_score.cu",
              "tpu3fs/placement/solver.py:205")
    k5s = ("tpu3fs_torch/csrc/swap_score.cu", "tpu3fs/placement/solver.py:205")
    k5a = ("tpu3fs_torch/csrc/swap_score.cu", "tpu3fs/placement/solver.py:261")
    return [
        record("gf2_matmul", "tensor_core", *k1, cmps["K1"], enc["new"],
               enc["old"], enc_plain, k1_bound, k1_by),
        record("gf2_matmul_bitslice", "bitslice", *k1, cmps["K1"], enc["old"],
               enc["old"], enc_plain, k1_bound, k1_by),
        record("crc32c_blocks", "tensor_core", *k2, cmps["K2"], crct["new"],
               crct["old"], crc_plain, k2_bound, k2_by),
        record("crc32c_blocks_table", "table", *k2, cmps["K2"], crct["old"],
               crct["old"], crc_plain, k2_bound, k2_by),
        record("xor_reduce", "one_pass", *k3, cmps["K3"], xort["new"],
               xort["old"], xort["old"], xor_bound, "bytes", NO_XOR_LIBRARY),
        record("xor_fold_crc", "one_launch", *k4_src, cmps["K4"],
               foldt["new"], foldt["old"], fold["plain_graph_ms"],
               fold["bound_ms"], "bytes", NO_FOLD_LIBRARY),
        record("xor_fold_crc_atomic", "memset_atomic", *k4_src,
               cmps["K4"], foldt["old"], None, fold["plain_graph_ms"],
               fold["bound_ms"], "bytes", NO_FOLD_LIBRARY),
        record("score_batch", "mma_s8", *k5_src, cmps["K5"],
               k5["score_cr_turns_ms"]["new"], None,
               k5["score_cr_turns_ms"]["old"], k5["score_cr_bound_ms"],
               k5["score_cr_bound_by"], NO_SCORE_LIBRARY),
        record("swap_score", "warp_per_move", *k5s, cmps["K5s"],
               k5["swap_cr_graph_ms"], k5["swap_cr_turns_ms"]["old"],
               k5["swap_cr_plain_ms"], k5["swap_cr_bound_ms"],
               k5["swap_cr_bound_by"], NO_SWAP_LIBRARY),
        record("swap_apply", "one_block", *k5a, cmps["K5a"],
               k5["apply_graph_ms"], None, k5["apply_plain_ms"],
               k5["apply_bound_ms"], k5["apply_bound_by"], NO_APPLY_LIBRARY),
    ]


def fold_variants(dev) -> dict:
    """``python3 chip_smoke.py --fold-variants``: K4's launch plan varied
    (cluster sizes, blocks per SM, the cooperative grid route forced where
    it applies), each plan's kernel held against the plain version and
    timed from CUDA graphs in turns with the atomic kernel at every shape of
    FOLD_SHAPES. The numbers the plan's constants were chosen by."""
    from unittest import mock

    from tpu3fs_torch.ops import xor_fold as xf

    base_plan = xf.fold_plan.__wrapped__  # uncached: constants are patched

    def with_consts(**consts):
        def plan(batch, size, sms):
            with mock.patch.multiple(xf, **consts):
                return base_plan(batch, size, sms)
        return plan

    def forced_grid(per_sm):
        def plan(batch, size, sms):
            if batch * size and batch <= 64:
                return xf.FoldPlan("grid", per_sm * sms)
            return base_plan(batch, size, sms)
        return plan

    def cluster_of(c):
        def plan(batch, size, sms):
            if size > 4096:
                return xf.FoldPlan("cluster", c * batch, c)
            return base_plan(batch, size, sms)
        return plan

    variants = {"plan": base_plan,
                "1 block/SM": with_consts(CTAS_PER_SM=1),
                "cluster 16": cluster_of(16),
                "cluster 8": cluster_of(8),
                "grid 2/SM": forced_grid(2)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cmp = Compare()
    out = {}
    # the table's shapes, then 1 MiB rows at 4-16 rows: where a cluster of
    # 16 blocks a row stops fitting one block an SM
    for batch, size, offset, _ in FOLD_SHAPES + [
            (b, MIB, 0, "") for b in (4, 6, 8, 9, 16)]:
        nbytes = batch * size
        n = 1 if nbytes < MIB else max(2, -(-75_000_000 // nbytes))
        batches = [fold_input((batch, size), offset, 400 + i, dev)
                   for i in range(n)]
        cyc = itertools.cycle(batches)
        want = xf.xor_fold_crc_plain(batches[0])
        row = {"bound_ms": (nbytes + 4 * batch) / HBM_BYTES_PER_S * 1e3}
        for name, plan in variants.items():
            with mock.patch.object(xf, "fold_plan", plan):
                cmp(xf.xor_fold_crc(batches[0]), want,
                    f"{batch} x {size} +{offset}, {name}")
                row[name] = {
                    "plan": plan(batch, size, sms)._asdict(),
                    "graph_turns_ms": turns(
                        lambda: xf.xor_fold_crc_atomic(next(cyc)),
                        lambda: xf.xor_fold_crc(next(cyc)), graph_ms)}
        out[f"{batch}x{size}+{offset}"] = row
        del batches, cyc
        torch.cuda.empty_cache()
    return out


# -- phase 16 ----------------------------------------------------------------
# Phase 13's records (4,096 of 8,192 int32 tokens, 32 KiB each, in 4 files;
# global batch 64 on the one-rank (dp, chain) mesh) on a fresh RS(12,4)
# fabric at phase 11's shape, fetched at depth 4 by 1, 2 and 4 workers, in
# turns (1, 2, 4, 4, 2, 1); a 64 MiB file at 1 MiB stripes read in 1 MiB
# sequential reads with readahead off and on (the client's defaults: 4 MiB
# windows on 2 workers), healthy and with the first node failed. The CPU
# route runs TRAIN_SMALL's records and a 4 MiB file.
FETCH_WORKERS, FETCH_DEPTH = (1, 2, 4, 4, 2, 1), 4
FETCH_FULL_MIB, FETCH_SMALL_MIB = 64, 4
FETCH_THREADS = ("dataload-fetch", "prefetch-", "client-")


def require_no_workers(what: str) -> None:
    """No fetch, readahead or fan-out worker is left alive: each is joined
    with a bound first (a pool's workers leave after its bounded join)."""
    for t in threading.enumerate():
        if t.name.startswith(FETCH_THREADS):
            t.join(10)
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith(FETCH_THREADS) and t.is_alive()]
    require(not alive, f"{what}: workers {alive} alive after close")


def fetch_run(dev, data: dict, mesh, tmp: Path, body: bytes,
              trace: bool = False, digest: bool = False) -> dict:
    """Phase 16 on a fresh RS(12,4) fabric on ``dev``: (1) the records
    packed into record files, then one shuffled, CRC-verified epoch of
    DTensor batches on ``mesh`` at each of FETCH_WORKERS, every batch's
    local tensor held against its records on ``dev``; (2) with the span
    log and a StructuredTraceLog on every storage service, the epoch at 4
    workers again and ``body`` written as one file; (3) CheckWorker and
    DumpWorker on every node, and the meta scans; (4) the file read in 1
    MiB reads with readahead off and on, healthy, then with the first node
    failed. With ``trace`` it runs only step 1's packing and one epoch at 4
    workers, under torch.profiler. Returns the record (batches' ids, with
    ``digest`` their sha256; span and event counts, dumps, scans, reads'
    sha256), each
    request's host time (with ``trace`` its device time), the stalls, the
    log format and the stage percentiles."""
    import hashlib
    from unittest import mock

    from tpu3fs_torch.analytics import assemble, spans
    from tpu3fs_torch.analytics.trace import (SerdeObjectReader,
                                              StructuredTraceLog,
                                              read_records)
    from tpu3fs_torch.client import FileIoClient
    from tpu3fs_torch.dataload import (DataLoader, LoaderConfig,
                                       PackedDataset, RecordFileWriter)
    from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
    from tpu3fs_torch.meta import scan
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.ops.stripe import StripeCodec
    from tpu3fs_torch.storage.craq import StorageEventTrace
    from tpu3fs_torch.storage.workers import CheckWorker, DumpWorker
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tokens = data["tokens"]
    rec, requests, stall, info = {}, {}, {}, {}

    def request(name, fn):
        return timed_request(requests, name, fn, dev, trace)

    fab = None
    try:
        with deterministic(16, step_clock=True) as clock:
            fab = Fabric(SystemSetupConfig(
                num_storage_nodes=FAB_NODES, num_chains=FAB_CHAINS,
                chunk_size=MIB, ec_k=K, ec_m=M), device=dev)
            fio = fab.file_client()
            fab.meta.mkdirs("/data", recursive=True)
            per = data["records"] // data["files"]
            paths = [f"/data/tokens{i}.rec" for i in range(data["files"])]
            for i, path in enumerate(paths):
                w = RecordFileWriter(fab.meta, fio, path, num_records=per)
                for r in data["host"][i * per:(i + 1) * per]:
                    w.append(r)
                w.commit()
            ds = PackedDataset(fab.meta, fio, paths)
            cfg = dict(global_batch=data["batch"], seed=5, dtype="<i4",
                       sample_shape=(SEQ_TOKENS,), depth=FETCH_DEPTH,
                       epochs=1)

            def check(b):
                local = b.data.to_local()
                require(isinstance(b.data, DTensor) and tuple(b.data.shape)
                        == (data["batch"], SEQ_TOKENS)
                        and b.data.placements == (Shard(0), Replicate())
                        and local.device == tokens.device and torch.equal(
                            local, tokens[torch.tensor(b.ids,
                                                       device=tokens.device)]),
                        f"batch {b.step}: its tokens differ from the records")
                return (b.epoch, b.step, b.ids, hashlib.sha256(
                    local.cpu().numpy().tobytes()).hexdigest()
                    if digest else None)

            def epoch(workers, key):
                with DataLoader(ds, LoaderConfig(workers=workers, **cfg),
                                mesh=mesh) as ld:
                    out = [check(b) for b in ld]
                    (stall[key],) = ld._stall_ms.collect(0.0)
                require_no_workers(f"the epoch at {workers} workers")
                return out

            # 1: the epoch at each worker count, in turns
            runs = FETCH_WORKERS[2:3] if trace else FETCH_WORKERS
            for turn, w in enumerate(runs):
                key = f"epoch_w{w}_{'ab'[turn >= len(runs) // 2]}"
                got = request(key, lambda: epoch(w, key))
                rec.setdefault("epoch", got)
                require(got == rec["epoch"], f"{key}: its batches differ "
                        "from the first epoch's")
            ids = sorted(i for _, _, b, _ in rec["epoch"] for i in b)
            require(ids == list(range(data["records"])),
                    "the epoch did not cover every record once")
            if trace:
                return {"record": rec, "requests": requests}
            # 2: spans and storage events for an epoch and a file write
            clock.advance()
            old_tracer = spans._TRACER
            spans._TRACER = spans.Tracer().configure(
                service="smoke", node=0, sample_rate=1.0,
                directory=str(tmp / "spans"))
            events = StructuredTraceLog("storage-event", str(tmp / "events"))
            for node in fab.nodes.values():
                node.service.set_trace_log(events)
            try:
                require(request("epoch_w4_spans",
                                lambda: epoch(4, "epoch_w4_spans"))
                        == rec["epoch"], "the traced epoch differs")
                res = fab.meta.create("/big", flags=OpenFlags.WRITE |
                                      OpenFlags.CREATE, client_id="smoke")
                request("write_file", lambda: fio.write(res.inode, 0, body))
                big = fab.meta.close(res.inode.id, res.session_id)
            finally:
                spans._TRACER.flush()
                span_paths = spans._TRACER.span_paths
                spans._TRACER = old_tracer
                for node in fab.nodes.values():
                    node.service.set_trace_log(None)
                events.flush()
            rows = assemble.load_spans([str(tmp / "spans")])
            trees = assemble.assemble_traces(rows)
            rec["fetch_traces"] = sum(
                1 for t in trees.values()
                if t.root is not None and t.root["op"] == "dataload.fetch")
            require(rec["fetch_traces"] == len(rec["epoch"]),
                    f"{rec['fetch_traces']} dataload.fetch traces for "
                    f"{len(rec['epoch'])} batches")
            ev = SerdeObjectReader(StorageEventTrace).read(events.paths)
            rec["file_event_rows"] = sorted(
                (e.chunk_index, e.length) for e in ev
                if e.file_id == big.id and e.length)
            require({c for c, _ in rec["file_event_rows"]}
                    == set(range(len(body) // MIB)), "a chunk of the written file "
                    "has no StorageEventTrace row")
            info["format"] = sorted({Path(p).suffix for p in
                                     span_paths + events.paths})
            # the fetch and the EC write emit op spans only: stage spans
            # come from CRAQ updates, chain-encode hops and KV txns
            info["stage_percentiles"] = assemble.stage_percentiles(rows)
            info["span_ops"] = dict(sorted(collections.Counter(
                r["op"] for r in rows).items()))
            fetch_us = sorted(t.root["dur_us"] for t in trees.values()
                              if t.root is not None
                              and t.root["op"] == "dataload.fetch")
            info["fetch_root_us"] = {
                q: fetch_us[min(len(fetch_us) - 1, int(q * len(fetch_us)))]
                for q in (0.5, 0.99)}
            # 3: maintenance passes and the meta scans
            dumped = []
            for node_id, node in sorted(fab.nodes.items()):
                require(CheckWorker(node.service).run_once() == 0,
                        f"CheckWorker offlined a target of node {node_id}")
                for path in DumpWorker(node.service, str(tmp / "dumps"),
                                       node_id=node_id).run_once():
                    dumped += [((r["file_id"], r["chunk_index"]),
                                r["committed_ver"], r["length"],
                                r["checksum"]) for r in read_records(path)]
            stored = fabric_stored(fab)
            require(sorted(dumped) == sorted(
                row[:2] + (row[3], row[4]) for rows_ in stored.values()
                for row in rows_), "DumpWorker's chunk records differ from "
                "the fabric's stored chunks")
            rec["dumped"] = sorted(dumped)
            rec["scan_inodes"] = sorted(i.id for i in scan.scan_inodes(
                fab.meta.engine))
            walked, todo = [fab.meta.stat("/").id], ["/"]
            while todo:
                d = todo.pop()
                for ent in fab.meta.list_dir(d):
                    p = d.rstrip("/") + "/" + ent.name
                    walked.append(ent.inode_id)
                    if fab.meta.stat(p).is_dir():
                        todo.append(p)
            require(rec["scan_inodes"] == sorted(walked), "the meta scan's "
                    "inodes differ from the MetaStore's")
            rec["namespace"] = scan.namespace_stats(fab.meta.engine)
            # 4: sequential 1 MiB reads, readahead off and on; healthy,
            # then the first node failed (K1 decodes)
            decoders = []
            reconstruct = StripeCodec.reconstruct_batch

            def spy(self, *a, **kw):
                decoders.append(threading.current_thread().name)
                return reconstruct(self, *a, **kw)

            def read_file(name, prefetch):
                client = FileIoClient(fab.storage_client(),
                                      prefetch=prefetch)
                try:
                    got = request(name, lambda: b"".join(
                        client.read(big, off, MIB)
                        for off in range(0, len(body), MIB)))
                    pf = client.prefetcher
                    if prefetch:
                        info[name] = {"hits": pf.hits._value,
                                      "misses": pf.misses._value,
                                      "failures": pf.failures._value}
                        require(pf.hits._value > 0 and
                                pf.failures._value == 0,
                                f"{name}: readahead {info[name]}")
                finally:
                    client.close()
                    client.storage.close()
                require_no_workers(name)
                require(got == body, f"{name}: the bytes read differ")
                rec.setdefault("reads", []).append(
                    (name, hashlib.sha256(got).hexdigest()))

            read_file("read_plain", False)
            read_file("read_readahead", True)
            fab.fail_node(sorted(fab.nodes)[0])
            with mock.patch.object(StripeCodec, "reconstruct_batch", spy):
                read_file("read_degraded_plain", False)
                del decoders[:]
                read_file("read_degraded_readahead", True)
            require(any(n.startswith("prefetch-") for n in decoders),
                    f"no degraded decode ran on a readahead thread "
                    f"({sorted(set(decoders))})")
            info["decode_threads"] = sorted(set(decoders))
        return {"record": rec, "requests": requests, "stall": stall,
                "info": info}
    finally:
        if fab is not None:
            for node in fab.nodes.values():
                node.service.stop_workers()


def fetch(dev, full: dict):
    """Concurrent fetch, readahead and the trace sink on the card: the
    sequence at small depth on the card (also the warm-up), then at full
    size (the main path), then at small depth on the CPU, whose record
    must equal the card's. Logs in a temporary directory. Returns the
    main run's launch counts and the run for ``fetch_shares``."""
    import tempfile

    t0 = phase("phase 16: concurrent fetch, readahead and the trace sink")
    small = train_data(dev, TRAIN_SMALL)
    bodies = {n: rand_u8((n * MIB,), 1616 + n, dev).cpu().numpy().tobytes()
              for n in (FETCH_SMALL_MIB, FETCH_FULL_MIB)}
    with tempfile.TemporaryDirectory() as tmp, one_rank_group(dev) as mesh:
        tmp = Path(tmp)
        card_small = fetch_run(dev, small, mesh, tmp / "small",
                               bodies[FETCH_SMALL_MIB], digest=True)
        zero_counts()
        card = fetch_run(dev, full, mesh, tmp / "full",
                         bodies[FETCH_FULL_MIB])
        counts = read_counts()
    require_main_path("concurrent fetch, readahead and the trace sink",
                      counts, ("gf2_matmul", "crc32c_blocks"))
    for name in ("read_degraded_plain", "read_degraded_readahead"):
        require(card["requests"][name]["launches"].get("gf2_matmul", 0) > 0,
                f"{name}: no K1 decode launched")
    cpu_dev = torch.device("cpu")
    t_cpu = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, \
            one_rank_group(cpu_dev) as mesh:
        cpu = fetch_run(cpu_dev, on_cpu(small), mesh, Path(tmp),
                        bodies[FETCH_SMALL_MIB], digest=True)
    card["cpu_route_s"] = time.perf_counter() - t_cpu
    for key, got in cpu["record"].items():
        require(got == card_small["record"][key],
                f"the CPU run's {key} differs from the card's")
    req = card["requests"]
    e2e = {}
    for key, st in card["stall"].items():
        if key in req:
            e2e[key] = {
                "samples_s": full["records"] / (req[key]["host_ms"] / 1e3),
                "stall_ms": {k: getattr(st, k) for k in (
                    "count", "mean", "p50", "p99", "max")},
                "K2": req[key]["launches"].get("crc32c_blocks", 0)}
    for name in ("read_plain", "read_readahead", "read_degraded_plain",
                 "read_degraded_readahead", "write_file"):
        e2e[name] = {"MiB_s": FETCH_FULL_MIB / (req[name]["host_ms"] / 1e3),
                     "K1": req[name]["launches"].get("gf2_matmul", 0),
                     **card["info"].get(name, {})}
    card["e2e"] = e2e
    info = card["info"]
    log(json.dumps({"fetch": e2e, "format": info["format"],
                    "span_ops": info["span_ops"],
                    "fetch_root_us": info["fetch_root_us"],
                    "stage_percentiles": info["stage_percentiles"],
                    "decode_threads": info["decode_threads"],
                    "card": card_line()}))
    log(f"fetch: launches {counts}, CPU route {card['cpu_route_s']:.1f} s "
        f"({time.perf_counter() - t0:.1f} s)")
    return counts, card


def fetch_shares(dev, run: dict, full: dict) -> None:
    """The epoch at 4 workers again on the card under torch.profiler for
    its device share, beside the main path's host times and launches.
    Runs after phase 15's traces, as ``storage_shares`` does."""
    import tempfile

    t0 = phase("phase 16 (continued): the epoch's device share")
    with tempfile.TemporaryDirectory() as tmp, one_rank_group(dev) as mesh:
        traced = fetch_run(dev, full, mesh, Path(tmp), b"", trace=True)
    require(traced["record"]["epoch"] == run["record"]["epoch"],
            "the traced epoch differs from the main path's")
    rows = {name: dict(row, traced=traced["requests"].get(name, {}))
            for name, row in run["requests"].items()}
    log(json.dumps({"fetch_requests": rows, "card": card_line(),
                    "cpu_route_s": run["cpu_route_s"],
                    "shapes": "4,096 records of 8,192 int32 tokens in 4 "
                              "files, global batch 64, depth 4, workers 1, "
                              "2 and 4; a 64 MiB file read in 1 MiB reads; "
                              "RS(12,4) over 4 nodes and 2 chains, 1 MiB "
                              "chunks"}))
    for name, row in rows.items():
        tr = row["traced"]
        shares = (f"traced host {tr['host_ms']:10.3f} ms, share "
                  f"{tr['device_share']:.4f}" if tr else "not traced")
        log(f"  {name:<24} host {row['host_ms']:10.3f} ms  K1 "
            f"{row['launches'].get('gf2_matmul', 0):5d} K2 "
            f"{row['launches'].get('crc32c_blocks', 0):6d}  {shares}")
    log(f"fetch shares ({time.perf_counter() - t0:.1f} s)")


# -- phase 17 ----------------------------------------------------------------
SOCK_IDS = (101, 102, 103, 104)        # phase 11's four storage nodes
SOCK_EC_CHAINS, SOCK_CR_CHAIN = (901, 902), 903
SOCK_MGMTD, SOCK_META = 1, 201
# MiB of the file written while a node is down, and of the one GC collects
SOCK_W_MIB, SOCK_C_MIB = 8, 2
SOCK_PARKED = "3600"                   # seconds: (a)'s loops never fire
SOCK_WAIT_S = 300.0                    # the bound on any one wait
SOCK_CHILD_STOP_S = 10.0               # SIGTERM -> exit, else killed
SOCK_WARM_STRIPES = 8                  # (a)'s warm-up pass
SOCK_MONITOR = 300                     # (b)'s monitor_collector
SOCK_PUSH_S = 0.5                      # (b)'s storage sample push period
# (b)'s epochs: one a worker count (phase 16's turns 1, 2, 4, 4, 2, 1 until
# phase 23 was added; halved for the script's time limit)
SOCK_FETCH_WORKERS = (1, 2, 4)
# the storage processes' data dirs, on the checkout's disk (never
# /dev/shm: the engine maps tmpfs and skips fsync there); git-ignored,
# each cluster's removed at its end
RUN_DIR = Path(__file__).resolve().parent / "_smoke_run"
OPENED = re.compile(r"node (\d+) opened target (\d+) \(chain \d+, (\w+), ")


def sock_wait(pred, what: str, timeout: float = SOCK_WAIT_S):
    """Poll ``pred`` until it returns a truthy value, at most ``timeout``
    seconds; a failed wait ends the run."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            got = pred()
        except Exception as e:  # a service still starting: poll again
            got, err = None, e
        else:
            err = None
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout:.0f} s waiting "
                                 f"for {what} (last error: {err!r})")
        time.sleep(0.1)


def free_port() -> int:
    """A port from a socket bound to port 0, closed just before use."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sock_layout(admin, ids) -> None:
    """Phase 11's chains over ``ids``, uploaded as an operator would: two
    RS(12,4) chains of 16 targets, shard j on node ids[j % 4] (4 targets of
    each chain a node), in chain table 1; a CR chain of 3 on the first
    three nodes, in chain table 2."""
    tid = 1001
    for chain_id in SOCK_EC_CHAINS:
        targets = []
        for j in range(K + M):
            admin.create_target(tid, node_id=ids[j % len(ids)])
            targets.append(tid)
            tid += 1
        admin.upload_chain(chain_id, targets, ec_k=K, ec_m=M)
    admin.upload_chain_table(1, list(SOCK_EC_CHAINS))
    targets = []
    for node_id in ids[:3]:
        admin.create_target(tid, node_id=node_id)
        targets.append(tid)
        tid += 1
    admin.upload_chain(SOCK_CR_CHAIN, targets)
    admin.upload_chain_table(2, [SOCK_CR_CHAIN])


def sock_serving(routing) -> bool:
    return all(t.public_state.name == "SERVING"
               for chain in routing.chains.values() for t in chain.targets)


def sock_reads_served(messenger, routing, node_id: int) -> bool:
    """Every target of ``node_id`` answers a target-addressed read of one
    of its committed chunks. mgmtd marks a restarted node's targets
    SERVING before the node's own routing says so (it learns that on a
    later heartbeat), and until then the node refuses such reads with
    TARGET_OFFLINE: a client retries them, admin_cli's
    ``verify-checksums --data`` does not."""
    from tpu3fs_torch.storage.craq import ReadReq

    for tid, info in routing.targets.items():
        if info.node_id != node_id or not info.chain_id:
            continue
        metas = [m for m in messenger(node_id, "dump_chunkmeta", tid)
                 if m.committed_ver > 0]
        if metas and not messenger(node_id, "batch_read", [ReadReq(
                info.chain_id, metas[0].chunk_id, target_id=tid)])[0].ok:
            return False
    return True


def sock_node_down(routing, node_id: int) -> bool:
    """Every target of ``node_id`` is out of service in ``routing``."""
    states = [t.public_state.name for chain in routing.chains.values()
              for t in chain.targets
              if routing.targets[t.target_id].node_id == node_id]
    return bool(states) and "SERVING" not in states


class SockInProcess:
    """Phase 17 (a): mgmtd, four storage apps and a meta app in this
    process on ``run_background``, over loopback TCP, all on ``dev``.
    mgmtd runs on a step clock and the apps' loops are parked, so the run
    drives heartbeats, mgmtd's ticks, target scans and resync rounds
    itself, as ``Fabric.fail_node``/``resync_all`` do in phase 11."""

    def __init__(self, dev):
        self.dev, self.apps, self.nodes = dev, [], {}
        self.clock = StepClock(step=True)
        try:
            self._boot()
        except BaseException:
            self.close()  # no app outlives a failed boot
            raise

    def _boot(self) -> None:
        from tpu3fs_torch.bin.meta_main import MetaApp
        from tpu3fs_torch.bin.mgmtd_main import MgmtdApp
        from tpu3fs_torch.rpc.services import MgmtdAdminRpcClient

        dev = self.dev
        self.mgmtd = MgmtdApp(
            ["--node-id", str(SOCK_MGMTD),
             f"--config.tick_interval_s={SOCK_PARKED}",
             "--config.heartbeat_timeout_s=60"],
            clock=self.clock.time, device=dev)
        self.mgmtd.run_background()
        self.apps.append(self.mgmtd)
        self.maddr = (self.mgmtd.info.hostname, self.mgmtd.info.port)
        self.admin = MgmtdAdminRpcClient(self.maddr)
        for node_id in SOCK_IDS:
            self._storage(node_id)
        sock_layout(self.admin, SOCK_IDS)
        for app in self.nodes.values():
            app.scan_targets()
        self.tick()
        self.meta_app = MetaApp(
            self._argv(SOCK_META)
            + [f"--config.gc_interval_s={SOCK_PARKED}"], device=dev)
        self.meta_app.run_background()
        self.apps.append(self.meta_app)
        self.tick()
        require(sock_serving(self.admin.refresh_routing()),
                "(a): a chain is not SERVING after boot")
        self.meta_addr = (self.meta_app.info.hostname,
                          self.meta_app.info.port)

    def _argv(self, node_id: int) -> list:
        return ["--node-id", str(node_id), "--mgmtd", "%s:%d" % self.maddr,
                "--heartbeat_interval", SOCK_PARKED]

    def _storage(self, node_id: int):
        from tpu3fs_torch.bin.storage_main import StorageApp

        app = StorageApp(self._argv(node_id) + [
            "--config.engine=mem", "--config.usrbio=0",
            f"--config.target_scan_interval_s={SOCK_PARKED}",
            f"--config.resync_interval_s={SOCK_PARKED}",
            f"--config.check_interval_s={SOCK_PARKED}",
            f"--config.punch_hole_interval_s={SOCK_PARKED}"],
            device=self.dev)
        app.run_background()
        self.apps.append(app)
        self.nodes[node_id] = app
        return app

    def tick(self) -> None:
        """Heartbeats, mgmtd's chain update, heartbeats again (their
        replies carry the new routing version to every app)."""
        live = [a for a in self.apps[1:] if not a.stopped]
        for app in live:
            app.heartbeat_once()
        self.mgmtd.mgmtd.tick()
        for app in live:
            app.heartbeat_once()

    def fail(self, node_id: int) -> None:
        app = self.nodes[node_id]
        app.stop()
        require(app.join(SOCK_CHILD_STOP_S), f"(a): node {node_id} did "
                "not stop")
        self.clock.advance(61.0)
        self.tick()
        require(sock_node_down(self.admin.refresh_routing(), node_id),
                f"(a): node {node_id}'s targets still serve")

    def restart(self, node_id: int) -> None:
        app = self._storage(node_id)
        app.heartbeat_once()  # a stale hb_version: fast-forwards
        app.scan_targets()
        self.tick()

    def rebuild(self) -> int:
        """Resync rounds on every live node until every chain serves."""
        from tpu3fs_torch.rpc.services import RpcMessenger
        from tpu3fs_torch.storage.ec_resync import EcResyncWorker
        from tpu3fs_torch.storage.resync import ResyncWorker

        moved = 0
        for _ in range(12):
            for app in self.nodes.values():
                if app.stopped:
                    continue
                messenger = RpcMessenger(lambda: app.mgmtd_client.routing())
                moved += ResyncWorker(app.service, messenger).run_once()
                moved += EcResyncWorker(app.service, messenger,
                                        device=self.dev).run_once()
            self.tick()
            if sock_serving(self.admin.refresh_routing()):
                return moved
        raise AssertionError("(a): the rebuild did not converge")

    def gc(self) -> int:
        return self.meta_app.run_gc()

    def close(self) -> list:
        for app in reversed(self.apps):
            app.stop()
        stuck = [type(a).__name__ for a in reversed(self.apps)
                 if not a.join(SOCK_CHILD_STOP_S)]
        return stuck


class SockProcesses:
    """Phase 17 (b): mgmtd, meta and the four storage nodes each in its own
    process, started from ``python -m tpu3fs_torch.bin.<name>_main
    --device <device>`` (never forked); their loops run on their own
    (heartbeats, mgmtd's ticks, target scans, resync and GC). Only
    mgmtd's port is chosen here (a socket bound to port 0, closed just
    before); every other address is read from mgmtd's routing. Logs go to
    ``logdir``, each child's xlog beside its output. Every child runs with
    ``env`` over this process's environment: phase 17 pins sockets
    (``TPU3FS_USRBIO=0``, and its storage processes take ``usrbio=0``),
    so its numbers stay comparable with those of the socket-only port.
    The storage processes run the JAX package's default engine (``auto``:
    the C++ engine on disk), each on its own data dir under RUN_DIR;
    ``close`` fails a storage process whose log shows a target on any
    other engine, and removes the data dirs. Each storage process pushes
    its samples to a ``monitor_main`` every ``push_s``: the node-tagged
    counters of its device work (``device_work_nodes``)."""

    env = {"TPU3FS_USRBIO": "0"}
    rpc = "python"                     # every child's --rpc
    push_s = SOCK_PUSH_S

    def __init__(self, logdir: Path, device: str = "cuda"):
        import tempfile

        self.logdir, self.device, self.procs = logdir, device, []
        self.shm = ShmLedger()
        self.engines = {}
        self.device_files = {}  # SIGKILLed pid -> its card files then
        logdir.mkdir(parents=True, exist_ok=True)
        RUN_DIR.mkdir(exist_ok=True)
        self.data_root = Path(tempfile.mkdtemp(
            prefix=f"{type(self).__name__}-", dir=RUN_DIR))
        try:
            self._boot()
        except BaseException:
            self.close()  # no child outlives a failed boot
            raise

    def _boot(self) -> None:
        from tpu3fs_torch.rpc.services import MgmtdAdminRpcClient

        self.mon_addr = ("127.0.0.1", free_port())
        self._start("monitor", "monitor_main", SOCK_MONITOR, [
            "--port", str(self.mon_addr[1]),
            f"--config.out_path={self.logdir / 'samples.db'}"])
        port = free_port()
        self.maddr = ("127.0.0.1", port)
        self.admin = MgmtdAdminRpcClient(self.maddr)
        self._start("mgmtd", "mgmtd_main", SOCK_MGMTD,
                    ["--port", str(port), "--config.tick_interval_s=0.5",
                     "--config.heartbeat_timeout_s=5"])
        sock_wait(lambda: self.admin.refresh_routing() is not None,
                  "mgmtd to answer")
        t0 = time.perf_counter()
        for node_id in SOCK_IDS:  # started together: each ~8 s to the card
            self._storage(node_id)
        for node_id in SOCK_IDS:
            self.registered(node_id)
        self.boot_s = time.perf_counter() - t0
        sock_layout(self.admin, SOCK_IDS)
        sock_wait(lambda: sock_serving(self.admin.refresh_routing()),
                  "every chain to serve")
        self._start("meta", "meta_main", SOCK_META,
                    ["--mgmtd=%s:%d" % self.maddr, "--heartbeat_interval",
                     "0.5", "--config.gc_interval_s=0.5"])
        node = self.registered(SOCK_META)
        self.meta_addr = (node.host, node.port)

    def _start(self, name: str, module: str, node_id: int, args: list):
        n = sum(1 for c in self.procs if c.node_id == node_id)
        name = name if not n else f"{name}-{n + 1}"
        path = self.logdir / f"{name}.log"
        xlog = self.logdir / f"{name}.xlog"
        rpc = ["--rpc", self.rpc] if self.rpc != "python" else []
        with open(path, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", f"tpu3fs_torch.bin.{module}",
                 "--node-id", str(node_id), "--device", self.device,
                 "--log_file", str(xlog), *rpc, *args],
                stdout=out, stderr=subprocess.STDOUT,
                env={**os.environ, **self.env})
        self.procs.append(SimpleNamespace(name=name, node_id=node_id,
                                          proc=proc, log=path, xlog=xlog,
                                          killed=False))

    def data_dir(self, node_id: int) -> Path:
        return self.data_root / f"node{node_id}"

    def push(self) -> list:
        """A child's flags that point its samples at the collector."""
        return [f"--config.collector={self.mon_addr[0]}:{self.mon_addr[1]}",
                f"--config.monitor_push_period_s={self.push_s}"]

    def _storage(self, node_id: int) -> None:
        self._start(f"storage{node_id}", "storage_main", node_id, [
            "--mgmtd=%s:%d" % self.maddr, "--heartbeat_interval", "0.5",
            f"--config.data_dir={self.data_dir(node_id)}",
            "--config.usrbio=0", "--config.target_scan_interval_s=0.5",
            "--config.resync_interval_s=0.5", *self.push()])

    def engine_classes(self) -> dict:
        """storage child -> {target id: the engine class its log names}."""
        out = {}
        for c in self.procs:
            if c.name.startswith("storage") and c.xlog.exists():
                out[c.name] = {int(t): cls for _, t, cls in
                               OPENED.findall(c.xlog.read_text())}
        return out

    def registered(self, node_id: int, after_port: int = 0):
        """The node's routing entry once it has registered an address
        (with ``after_port``: one other than that, a restarted node)."""
        def node():
            n = self.admin.refresh_routing().nodes.get(node_id)
            return n if n is not None and n.host and n.port \
                and n.port != after_port else None
        return sock_wait(node, f"node {node_id} to register")

    def pid_of(self, prefix: str) -> list:
        """The pids of the live children whose names start with
        ``prefix``."""
        return [c.proc.pid for c in self.procs
                if c.name.startswith(prefix) and c.proc.poll() is None]

    def snap_shm(self) -> None:
        """Note the /dev/shm names the script and every live child map."""
        self.shm.snap([os.getpid()] + [c.proc.pid for c in self.procs
                                       if c.proc.poll() is None])

    def sigkill(self, child) -> None:
        """SIGKILL a child, its /dev/shm names noted first: it is stopped
        (SIGSTOP) while the names are read, so it maps no new one."""
        import signal

        child.proc.send_signal(signal.SIGSTOP)
        self.snap_shm()
        self.device_files[child.proc.pid] = fleet_device_files(child.proc.pid)
        self.shm.killed.add(child.proc.pid)
        child.proc.send_signal(signal.SIGKILL)
        child.proc.wait(SOCK_CHILD_STOP_S)
        child.killed = True

    def fail(self, node_id: int) -> None:
        """SIGKILL the node's process; wait for mgmtd to take its targets
        out of service."""
        self.sigkill([c for c in self.procs if c.node_id == node_id][-1])
        sock_wait(lambda: sock_node_down(self.admin.refresh_routing(),
                                         node_id),
                  f"mgmtd to take node {node_id}'s targets down")

    def restart(self, node_id: int, keep_data: bool = False) -> None:
        """A new process for the node: by default on an emptied data dir
        (a replaced disk: its targets start empty), with ``keep_data`` on
        the dir the killed process left (its WAL replays)."""
        import shutil

        old = self.admin.refresh_routing().nodes[node_id].port
        if not keep_data:
            shutil.rmtree(self.data_dir(node_id), ignore_errors=True)
        self._storage(node_id)
        self.registered(node_id, after_port=old)

    def rebuild(self) -> int:
        """The storage processes' own resync loops rebuild the new node's
        targets: wait until every chain serves."""
        sock_wait(lambda: sock_serving(self.admin.refresh_routing()),
                  "the rebuild to bring every chain back")
        return 0

    def gc(self) -> int:
        return 0  # meta's own GC loop collects (every 0.5 s)

    def close(self, keep_data: bool = False) -> list:
        """SIGTERM every live child and wait for each; -> problems: a
        child that had to be killed, exited non-zero, or whose log holds
        a traceback, or a storage process off the native engine. A child
        killed on purpose exits -9. The data dirs go too, unless
        ``keep_data`` (then ``remove_data`` removes them)."""
        import signal

        bad = []
        self.snap_shm()
        live = [c for c in self.procs if c.proc.poll() is None]
        for c in live:
            c.proc.send_signal(signal.SIGTERM)
        for c in live:
            try:
                c.proc.wait(SOCK_CHILD_STOP_S)
            except subprocess.TimeoutExpired:
                c.proc.kill()
                c.proc.wait(SOCK_CHILD_STOP_S)
                bad.append(f"{c.name} ignored SIGTERM for "
                           f"{SOCK_CHILD_STOP_S:.0f} s and was killed")
        for c in self.procs:
            want = -9 if c.killed else 0
            if c.proc.returncode != want and not any(
                    b.startswith(c.name + " ") for b in bad):
                bad.append(f"{c.name} exited {c.proc.returncode}")
            text = c.log.read_text(errors="replace")
            if "Traceback" in text:
                bad.append(f"{c.name}'s log holds a traceback:\n"
                           + text[text.index("Traceback"):][:2000])
        # every target of every storage process on the C++ engine: "auto"
        # falls back to the mem engine with only a WARN when the library
        # does not build
        self.engines = self.engine_classes()
        for name, targets in self.engines.items():
            killed = any(c.killed for c in self.procs if c.name == name)
            if not targets and not killed:
                bad.append(f"{name}'s log names no opened target")
            other = {t: cls for t, cls in targets.items()
                     if cls != "NativeChunkEngine"}
            if other:
                bad.append(f"{name} opened targets off the native engine: "
                           f"{other}")
        if not keep_data:
            self.remove_data()
        return bad

    def remove_data(self) -> None:
        """Remove this cluster's data dirs (and RUN_DIR once empty)."""
        import shutil

        shutil.rmtree(self.data_root, ignore_errors=True)
        with contextlib.suppress(OSError):
            RUN_DIR.rmdir()


def sock_inputs(depth: int = FAB_STRIPES) -> dict:
    """Phase 11's files (``serving_inputs``: /a and /b of ``depth`` stripes
    of 1 MiB, the overwrite, /cr), the file written while a node is down
    and the one meta's GC collects."""
    rng = np.random.default_rng(1717)
    u8 = lambda n: rng.integers(0, 256, n, dtype=np.uint8).tobytes()  # noqa: E731
    return dict(serving_inputs(depth), w=u8(SOCK_W_MIB * MIB),
                c=u8(SOCK_C_MIB * MIB))


# shard reads a batchReadRebuild call: its reply estimate is twice the
# chunk size (1 MiB when unknown) a read to the end, and over a ring the
# reply region must fit the client's 64 MiB iov, or the call quietly
# rides a socket
SHARD_READS_A_CALL = 16


def read_shards(sc, node_id: int, reqs: list) -> list:
    """``sc.batch_read_rebuild`` of ``reqs`` to one node, SHARD_READS_A_CALL
    at a time."""
    out = []
    for i in range(0, len(reqs), SHARD_READS_A_CALL):
        out += sc.batch_read_rebuild(node_id,
                                     reqs[i:i + SHARD_READS_A_CALL])
    return out


def sock_shards(sc, routing, inode, body: bytes, dev) -> int:
    """Every shard of every stripe of ``inode`` as the storage nodes hold
    it (read over the wire, ``batchReadRebuild``) against its
    client-encoded twin (the file's stripes encoded here by ``RSCode`` on
    ``dev``, trimmed as stored), and its CRC against ``crc32c_many``; the
    first GOLD_STRIPES stripes also against ``encode_np`` and
    ``crc32c_py``. -> the shards checked."""
    from tpu3fs_torch.ops.crc32c import crc32c_many, crc32c_py
    from tpu3fs_torch.ops.rs import RSCode
    from tpu3fs_torch.ops.stripe import shard_size_of
    from tpu3fs_torch.storage.craq import ReadReq
    from tpu3fs_torch.storage.types import ChunkId

    S = shard_size_of(MIB, K)
    n = -(-len(body) // MIB)
    stripes = np.zeros((n, K * S), dtype=np.uint8)
    for i in range(n):
        chunk = np.frombuffer(body[i * MIB:(i + 1) * MIB], np.uint8)
        stripes[i, :chunk.size] = chunk
    stripes = stripes.reshape(n, K, S)
    rs = RSCode(K, M, device=dev)
    parity = rs.encode(torch.from_numpy(stripes).to(dev)).cpu().numpy()
    twins = np.concatenate([stripes, parity], axis=1)
    gold = RSCode(K, M, device="cpu").encode_np(stripes[:GOLD_STRIPES])
    require(np.array_equal(parity[:GOLD_STRIPES], gold),
            "the card's encode differs from encode_np")
    by_node = collections.defaultdict(list)
    for i in range(n):
        chain = routing.chains[inode.layout.chain_of_chunk(i)]
        for j in range(K + M):
            tid = chain.target_of_shard(j).target_id
            by_node[routing.targets[tid].node_id].append(
                (i, j, ReadReq(chain.chain_id, ChunkId(inode.id, i),
                               target_id=tid)))
    held, bufs = [], []
    for node_id, items in by_node.items():
        replies = read_shards(sc, node_id, [r for _, _, r in items])
        for (i, j, _), rp in zip(items, replies):
            require(rp.ok, f"stripe {i} shard {j}: {rp.code!r}")
            got = bytes(rp.data)
            require(got == twins[i, j, :len(got)].tobytes(),
                    f"stripe {i} shard {j} differs from its client-encoded "
                    "twin")
            if i < GOLD_STRIPES:
                require(rp.checksum.value == crc32c_py(got),
                        f"stripe {i} shard {j}: CRC vs crc32c_py")
            held.append(rp.checksum.value)
            bufs.append(got)
    require(crc32c_many(bufs, device=dev) == held,
            "a shard's CRC differs from its bytes' CRC")
    return len(held)


def sock_sequence(ctl, dev, inputs: dict, requests: dict,
                  uncounted: collections.Counter, warm: tuple,
                  trace: bool = False) -> dict:
    """Phase 11's requests through ``MetaRpcClient``, ``StorageClient`` and
    ``RpcMessenger`` against ``ctl`` (either part's cluster): write /a (48
    stripes of 1 MiB), read it, a 5,000-byte overwrite (the delta RMW);
    fail the first node, read /a degraded, write /w while it is down;
    start it again empty and rebuild until every chain serves; read both;
    write /b chain-encoded; every stored shard of /a, /w and /b against
    its client-encoded twin; remove /c and /w and collect them with
    meta's GC; 64 chunks of 256 KiB on the CR chain. Every byte read is
    checked. The checks' own launches are added to ``uncounted``. ``warm``
    is the warm-up file, whose shards the rebuild brings back too. With
    ``trace`` each request runs under torch.profiler (its device time)."""
    import hashlib
    from unittest import mock

    from tpu3fs_torch.client.file_io import FileIoClient
    from tpu3fs_torch.client.storage_client import StorageClient
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.meta.types import Layout
    from tpu3fs_torch.rpc.services import MetaRpcClient, RpcMessenger
    from tpu3fs_torch.storage.craq import ReadReq
    from tpu3fs_torch.storage.types import ChunkId

    rec = {"reads": []}
    part_b = isinstance(ctl, SockProcesses)  # its rebuild runs out of sight
    meta = MetaRpcClient([ctl.meta_addr], client_id="smoke")
    routing = ctl.admin.refresh_routing
    sc = StorageClient("smoke", routing, RpcMessenger(routing), device=dev)
    fio = FileIoClient(sc)

    def request(name, fn):
        return timed_request(requests, name, fn, dev, trace)

    @contextlib.contextmanager
    def not_counted():
        before = read_counts()
        yield
        after = read_counts()
        uncounted.update({n: after[n] - before[n] for n in after})

    def write(name, path, body, layout=None):
        kw = {"layout": layout} if layout is not None else {}
        res = meta.create(path, flags=OpenFlags.WRITE | OpenFlags.CREATE,
                          client_id="smoke", **kw)
        request(name, lambda: fio.write(res.inode, 0, body))
        return meta.close(res.inode.id, res.session_id)

    def read(name, inode, want):
        got = request(name, lambda: fio.read(inode, 0, len(want)))
        require(got == want, f"{name}: the bytes read differ")
        rec["reads"].append((name, hashlib.sha256(got).hexdigest()))

    def victim_shards(node_id, files):
        """The node's shards of ``files`` (bytes, chunks), read over the
        wire after the rebuild: what it brought back."""
        r = routing()
        reqs = []
        for inode, body in files:
            for i in range(-(-len(body) // MIB)):
                chain = r.chains[inode.layout.chain_of_chunk(i)]
                for t in chain.targets:
                    if r.targets[t.target_id].node_id == node_id:
                        reqs.append(ReadReq(chain.chain_id,
                                            ChunkId(inode.id, i),
                                            target_id=t.target_id))
        replies = read_shards(sc, node_id, reqs)
        require(all(rp.ok for rp in replies), "a victim shard is unreadable")
        return sum(len(rp.data) for rp in replies), len(replies)

    try:
        body = bytearray(inputs["a"])
        a = write("write", "/a", bytes(body))
        read("read", a, bytes(body))
        off, patch = inputs["patch"]
        request("overwrite_5000B", lambda: fio.write(a, off, patch))
        body[off:off + len(patch)] = patch
        body = bytes(body)
        victim = SOCK_IDS[0]
        ctl.fail(victim)
        read("degraded_read", a, body)
        w = write("write_while_down", "/w", inputs["w"])
        read("read_while_down", w, inputs["w"])
        ctl.restart(victim)
        rec["moved"] = request("rebuild", ctl.rebuild)
        lost, lost_chunks = victim_shards(victim, [warm, (a, body),
                                                   (w, inputs["w"])])
        requests["rebuild"]["lost_bytes"] = lost
        requests["rebuild"]["lost_chunks"] = lost_chunks
        require(part_b or rec["moved"] == lost_chunks, f"the rebuild moved "
                f"{rec['moved']} of the node's {lost_chunks} shards")
        read("read_after_rebuild", a, body)
        read("read_w_after_rebuild", w, inputs["w"])
        with mock.patch.dict("os.environ", {"TPU3FS_EC_CHAIN_ENCODE": "1"}):
            b = write("chain_encode_write", "/b", inputs["b"])
        read("chain_encoded_read", b, inputs["b"])
        with not_counted():
            r = routing()
            rec["shards_checked"] = sum(
                sock_shards(sc, r, inode, data, dev) for inode, data in
                ((a, body), (w, inputs["w"]), (b, inputs["b"])))
        c = write("gc_file_write", "/c", inputs["c"])
        for path in ("/c", "/w"):
            meta.remove(path)
        gone = [(c, len(inputs["c"])), (w, len(inputs["w"]))]

        def collected():
            r = routing()
            for inode, size in gone:
                for i in range(-(-size // MIB)):
                    chain = r.chains[inode.layout.chain_of_chunk(i)]
                    t = chain.target_of_shard(0).target_id
                    rp = sc.batch_read_rebuild(
                        r.targets[t].node_id,
                        [ReadReq(chain.chain_id, ChunkId(inode.id, i),
                                 target_id=t)])[0]
                    if rp.ok:
                        return False
            return True

        rec["gc"] = request("gc", lambda: (ctl.gc(), sock_wait(
            collected, "meta's GC to remove the files' chunks"))[0])
        cr_body = inputs["cr"]
        cr = write("cr_write", "/cr", cr_body, Layout(
            table_id=2, chains=[SOCK_CR_CHAIN], chunk_size=CR_FAB_CHUNK))
        read("cr_read", cr, cr_body)
        rec["lengths"] = [meta.stat(p).length for p in ("/a", "/b", "/cr")]
        require(rec["lengths"] == [len(body), len(inputs["b"]), len(cr_body)],
                f"file lengths {rec['lengths']}")
        return rec
    finally:
        fio.close()
        sc.close()


def sock_mibps(requests: dict, inputs: dict) -> dict:
    """Write, read, degraded-read and rebuild MiB/s (the rebuild's over the
    failed node's bytes)."""
    n = len(inputs["a"])
    sizes = {"write": n, "read": n, "degraded_read": n,
             "rebuild": requests["rebuild"]["lost_bytes"]}
    return {k: sizes[k] / MIB / (requests[k]["host_ms"] / 1e3)
            for k in sizes}


def sock_dataload(ctl, dev, data: dict, mesh, body: bytes, requests: dict,
                  stall: dict, info: dict) -> dict:
    """Phase 16's workload over the processes: phase 13's records written
    into 4 record files through ``MetaRpcClient`` and the socket client,
    one shuffled, CRC-verified epoch at depth 4 with 1, 2 and 4 fetch
    workers (SOCK_FETCH_WORKERS; each the same (epoch, step, ids), each batch held
    against its records on ``dev``); then ``body`` written as one file and
    read in 1 MiB reads with readahead off and on, healthy and with the
    second storage process killed. A fresh client a run, closed after it:
    no fetch, readahead or fan-out worker is left."""
    import hashlib

    from tpu3fs_torch.client.file_io import FileIoClient
    from tpu3fs_torch.client.storage_client import StorageClient
    from tpu3fs_torch.dataload import (DataLoader, LoaderConfig,
                                       PackedDataset, RecordFileWriter)
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.rpc.services import MetaRpcClient, RpcMessenger
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tokens, rec = data["tokens"], {}
    meta = MetaRpcClient([ctl.meta_addr], client_id="smoke-data")
    routing = ctl.admin.refresh_routing

    def request(name, fn):
        return timed_request(requests, name, fn, dev, False)

    @contextlib.contextmanager
    def client(prefetch=False):
        sc = StorageClient(f"smoke-{len(requests)}", routing,
                           RpcMessenger(routing), device=dev)
        fio = FileIoClient(sc, prefetch=prefetch)
        try:
            yield fio
        finally:
            fio.close()
            sc.close()

    meta.mkdirs("/data", recursive=True)
    per = data["records"] // data["files"]
    paths = [f"/data/tokens{i}.rec" for i in range(data["files"])]
    with client() as fio:
        def pack():
            for i, path in enumerate(paths):
                w = RecordFileWriter(meta, fio, path, num_records=per)
                for r in data["host"][i * per:(i + 1) * per]:
                    w.append(r)
                w.commit()
        request("pack_records", pack)
    cfg = dict(global_batch=data["batch"], seed=5, dtype="<i4",
               sample_shape=(SEQ_TOKENS,), depth=FETCH_DEPTH, epochs=1)

    def check(b):
        local = b.data.to_local()
        require(isinstance(b.data, DTensor) and tuple(b.data.shape)
                == (data["batch"], SEQ_TOKENS)
                and b.data.placements == (Shard(0), Replicate())
                and local.device == tokens.device and torch.equal(
                    local, tokens[torch.tensor(b.ids, device=tokens.device)]),
                f"batch {b.step}: its tokens differ from the records")
        return (b.epoch, b.step, b.ids)

    def epoch(workers, key):
        with client() as fio:
            ds = PackedDataset(meta, fio, paths)
            with DataLoader(ds, LoaderConfig(workers=workers, **cfg),
                            mesh=mesh) as ld:
                out = [check(b) for b in ld]
                (stall[key],) = ld._stall_ms.collect(0.0)
        require_no_workers(f"the socket epoch at {workers} workers")
        return out

    for w in SOCK_FETCH_WORKERS:
        key = f"epoch_w{w}_a"
        got = request(key, lambda: epoch(w, key))
        rec.setdefault("epoch", got)
        require(got == rec["epoch"], f"{key}: its batches differ from the "
                "first epoch's")
    # the client process's device share: one more epoch at 4 workers
    # under torch.profiler (the storage processes' are out of its sight)
    require(timed_request(requests, "epoch_w4_traced",
                          lambda: epoch(4, "epoch_w4_traced"), dev,
                          dev.type == "cuda") == rec["epoch"],
            "the traced epoch differs from the first epoch")
    ids = sorted(i for _, _, b in rec["epoch"] for i in b)
    require(ids == list(range(data["records"])),
            "the epoch did not cover every record once")
    res = meta.create("/big", flags=OpenFlags.WRITE | OpenFlags.CREATE,
                      client_id="smoke-data")
    with client() as fio:
        request("write_file", lambda: fio.write(res.inode, 0, body))
    big = meta.close(res.inode.id, res.session_id)

    def read_file(name, prefetch):
        with client(prefetch) as fio:
            got = request(name, lambda: b"".join(
                fio.read(big, off, MIB) for off in range(0, len(body), MIB)))
            pf = fio.prefetcher
            if prefetch:
                info[name] = {"hits": pf.hits._value,
                              "misses": pf.misses._value,
                              "failures": pf.failures._value}
                require(pf.hits._value > 0 and pf.failures._value == 0,
                        f"{name}: readahead {info[name]}")
        require_no_workers(name)
        require(got == body, f"{name}: the bytes read differ")
        rec.setdefault("reads", []).append(
            (name, hashlib.sha256(got).hexdigest()))

    read_file("read_plain", False)
    read_file("read_readahead", True)
    ctl.fail(SOCK_IDS[1])
    read_file("read_degraded_plain", False)
    read_file("read_degraded_readahead", True)
    return rec


def sock_warm(ctl, dev) -> tuple:
    """One 4-stripe file through a fresh cluster before its requests are
    timed: every storage node's first install (in (b) its CUDA context
    and the kernel library's load), the client's codec and connections.
    -> (inode, bytes) of the file (its shards are rebuilt too)."""
    from tpu3fs_torch.client.file_io import FileIoClient
    from tpu3fs_torch.client.storage_client import StorageClient
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.rpc.services import MetaRpcClient, RpcMessenger

    body = np.random.default_rng(0).integers(
        0, 256, 4 * MIB, dtype=np.uint8).tobytes()
    meta = MetaRpcClient([ctl.meta_addr], client_id="smoke-warm")
    routing = ctl.admin.refresh_routing
    sc = StorageClient("smoke-warm", routing, RpcMessenger(routing),
                       device=dev)
    fio = FileIoClient(sc)
    try:
        res = meta.create("/warm", flags=OpenFlags.WRITE | OpenFlags.CREATE,
                          client_id="smoke-warm")
        fio.write(res.inode, 0, body)
        inode = meta.close(res.inode.id, res.session_id)
        require(fio.read(inode, 0, len(body)) == body,
                "the warm-up file's bytes differ")
        return inode, body
    finally:
        fio.close()
        sc.close()


def device_work_nodes(ctl) -> dict:
    """The storage nodes whose own counters show device work in the phase:
    it coordinated an EC rebuild (``ec.rebuild_shards``: K1 decodes) or
    accumulated chain-encode parity (``ec.chain_encode_bytes``: K1 and K2
    a hop), by the node tag of the samples its processes pushed to the
    phase's collector, read once two reads ``ctl.push_s`` apart agree.
    -> node id -> the pids of its storage processes, live or SIGKILLed."""
    from tpu3fs_torch.monitor.collector import (COLLECTOR_SERVICE_ID,
                                                AggQueryReq, AggQueryRsp)
    from tpu3fs_torch.rpc.net import RpcClient

    cli = RpcClient()

    def read() -> dict:
        got = collections.Counter()
        for name in ("ec.rebuild_shards", "ec.chain_encode_bytes"):
            rsp = cli.call(ctl.mon_addr, COLLECTOR_SERVICE_ID, 3,
                           AggQueryReq(name=name, window_s=3600.0),
                           AggQueryRsp)
            for row in rsp.rows:
                if row.vsum and "node" in row.tags:
                    got[int(row.tags["node"])] += row.vsum
        return dict(got)

    try:
        deadline = time.monotonic() + 60.0
        prev = None
        while True:
            time.sleep(2.5 * ctl.push_s)
            cur = read()
            if cur == prev:
                break
            require(time.monotonic() < deadline,
                    "the collector's device-work counters never settled")
            prev = cur
    finally:
        cli.close()
    return {n: [c.proc.pid for c in ctl.procs
                if c.node_id == n and c.name.startswith("storage")]
            for n in sorted(cur)}


def sock_on_card(pids, killed=None, worked=None) -> dict:
    """Which storage (or serving) processes did device work on the card. A
    process that launched a kernel holds a CUDA context, which maps
    ``/dev/nvidia-uvm`` (asking whether a card exists, as ``--device
    cuda`` does, opens the card's files but makes no context), and has
    mapped the built kernel library; ``nvidia-smi`` lists it among the
    compute apps, or, where nvidia-smi sees the processes in another pid
    namespace (it may list every process as pid 1), counts one app for
    it. ``killed``: the card files of the processes SIGKILLed during the
    phase, read just before each kill. On the C++ engine a storage process
    checksums on the host, so only its decodes and chain-encode hops
    launch kernels: a process with no context is reported under
    ``no_launch``, at least one must have launched, and every node in
    ``worked`` (``device_work_nodes``: its counters show decodes or
    hops) must have launched in one of its processes, which a process
    that ran that work on the CPU would not. -> nvidia-smi's listing,
    each launching pid's proof and the pids with no launch."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    listed = {int(line.split(",")[0]) for line in smi if line.strip()}
    seen = {pid: fleet_device_files(pid) for pid in pids}
    proof, idle = {}, []
    for pid, files in [*seen.items(), *(killed or {}).items()]:
        if "/dev/nvidia-uvm" not in files["mapped"]:
            idle.append(pid)
            continue
        require(files["kernel_library"], f"process {pid} holds a CUDA "
                f"context but no kernel library: {files}")
        proof[pid] = ("nvidia-smi" if pid in listed else
                      "CUDA context and kernel library mapped"
                      + (" when SIGKILLed" if pid not in seen else ""))
    require(proof, f"no storage process launched a kernel ({pids}, "
            f"killed {sorted(killed or {})})")
    for node_id, node_pids in (worked or {}).items():
        require(set(node_pids) & set(proof), f"node {node_id} did device "
                f"work, but none of its processes {node_pids} holds a "
                f"CUDA context and the kernel library: {seen}")
    live = set(proof) & set(seen)
    if not live <= listed:
        # another pid namespace: nvidia-smi must still count a compute
        # app for this process and for each live one with a context
        require(len(smi) >= 1 + len(live), f"nvidia-smi lists {len(smi)} "
                f"compute apps for this process and {len(live)} live "
                f"processes with a CUDA context: {smi}")
    return {"nvidia_smi": smi, "pids": proof, "no_launch": idle,
            "worked": sorted(worked or {})}


def sock_part(part: str, dev, full: dict, inputs: dict, body: bytes,
              logdir: Path, trace: bool = False) -> dict:
    """One part of phase 17 on ``dev``: (a) the apps in this process, (b)
    the services as processes (with phase 16's workload over them; the
    nvidia-smi check on a card). Every kernel count is zeroed before the
    part's requests and read after them, the checks' own launches taken
    out. -> launches, each request's host time and launches, rates."""
    requests, uncounted, stall, info = {}, collections.Counter(), {}, {}
    t0 = time.perf_counter()
    ctl, problems = None, []
    try:
        ctl = (SockInProcess(dev) if part == "a" else
               SockProcesses(logdir, "cuda" if dev.type == "cuda" else "cpu"))
        warm = sock_warm(ctl, dev)
        zero_counts()
        rec = sock_sequence(ctl, dev, inputs, requests, uncounted, warm,
                            trace)
        if part == "b":
            if dev.type == "cuda":
                info["on_card"] = sock_on_card(ctl.pid_of("storage"),
                                               ctl.device_files,
                                               device_work_nodes(ctl))
            with one_rank_group(dev) as mesh:
                rec["data"] = sock_dataload(ctl, dev, full, mesh, body,
                                            requests, stall, info)
        counts = read_counts()
    finally:
        if ctl is not None:
            problems = ctl.close()
    require(not problems, f"phase 17 ({part}): {problems}")
    counts = {n: c - uncounted[n] for n, c in counts.items()}
    e2e = {"MiB_s": sock_mibps(requests, inputs), "moved": rec["moved"],
           "gc": rec["gc"], "shards_checked": rec["shards_checked"]}
    for key, st in stall.items():
        e2e[key] = {
            "samples_s": full["records"] / (requests[key]["host_ms"] / 1e3),
            "stall_ms": {k: getattr(st, k) for k in (
                "count", "mean", "p50", "p99", "max")},
            "K2": requests[key]["launches"].get("crc32c_blocks", 0)}
    for name in ("read_plain", "read_readahead", "read_degraded_plain",
                 "read_degraded_readahead", "write_file"):
        if name in requests:
            e2e[name] = {
                "MiB_s": len(body) / MIB / (requests[name]["host_ms"] / 1e3),
                "K1": requests[name]["launches"].get("gf2_matmul", 0),
                **info.get(name, {})}
    if part == "b":
        e2e["boot_s"] = ctl.boot_s
        e2e["on_card"] = info.get("on_card")
    return {"launches": counts, "requests": requests, "e2e": e2e,
            "record": rec, "seconds": time.perf_counter() - t0}


def sockets(dev, full: dict) -> dict:
    """Phase 17: the services over sockets, (a) in this process, then (b)
    as processes from their entry points, on the card. Every byte is
    checked, and every K1, K2 and K3 call the script counts must be a
    tensor-core or kernel launch. Returns the launches of both parts: for
    (b) the client's only, since the storage processes' launches are not
    visible to this process."""
    from unittest import mock

    t0 = phase("phase 17: the services over sockets")
    with mock.patch.dict(os.environ, {"TPU3FS_USRBIO": "0"}):
        return sockets_pinned(dev, full, t0)


def sockets_pinned(dev, full: dict, t0: float) -> dict:
    """Phase 17's body, with every messenger of the script (and of part
    (a)'s apps) built under ``TPU3FS_USRBIO=0``."""
    import tempfile

    inputs = sock_inputs()
    body = rand_u8((FETCH_FULL_MIB * MIB,), 1717, dev).cpu().numpy().tobytes()
    totals, runs = collections.Counter(), {}
    # warm-up (codecs, allocator) at 8 stripes, not phase 11's 48: the
    # script's time limit makes room for phase 19 here
    with tempfile.TemporaryDirectory() as tmp:
        sock_part("a", dev, full, sock_inputs(SOCK_WARM_STRIPES), body,
                  Path(tmp))
    for part in ("a", "b"):
        with tempfile.TemporaryDirectory() as tmp:
            run = runs[part] = sock_part(part, dev, full, inputs, body,
                                         Path(tmp))
        # (a) rebuilds in this process (K3 for a single lost shard); (b)'s
        # rebuild runs in the storage processes, out of the script's count
        require_main_path(f"the services over sockets ({part})",
                          run["launches"], ("gf2_matmul", "crc32c_blocks")
                          + (("xor_reduce",) if part == "a" else ()))
        totals.update(run["launches"])
        log(json.dumps({"sockets": part, "e2e": run["e2e"],
                        "requests": run["requests"],
                        "launches": run["launches"], "card": card_line(),
                        "seconds": run["seconds"]}))
    # (a) once more, each request under torch.profiler: the device share
    # of the one process that holds the whole cluster
    with tempfile.TemporaryDirectory() as tmp:
        traced = sock_part("a", dev, full, inputs, body, Path(tmp),
                           trace=True)
    require(traced["record"]["reads"] == runs["a"]["record"]["reads"],
            "the traced run's reads differ from the main path's")
    shares = {name: {"host_ms": row["host_ms"],
                     "traced": traced["requests"][name]}
              for name, row in runs["a"]["requests"].items()}
    log(json.dumps({"sockets_shares": shares, "card": card_line()}))
    log(f"sockets: launches {dict(totals)} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {n: totals[n] for n in counters()}


# -- phase 18 ----------------------------------------------------------------
FLEET_KVD = (11, 12, 13)               # the kvd group's member ids
FLEET_META = (201, 202)                # two meta servers, partitioned
FLEET_PARTS = 4                        # meta partitions
FLEET_SERVING = (61, 62)               # the serving processes
FLEET_MONITOR = 300                    # monitor_collector
FLEET_HOST = 70                        # this script, the inference host
FLEET_TIER = 1 << 30                   # each host tier: A is 512 MiB
FLEET_BATCH = 16                       # pages a decode-step chunk fetches
# A, B's shared prefix, B's own pages: half of phase 12's (256, 192, 64),
# to make room for phase 19 in the script's time limit
FLEET_FULL = (128, 96, 32)
FLEET_SF_K = 8                         # concurrent misses of one key
FLEET_PUSH_S = 1.0                     # every process's sample push period
FLEET_FAILOVER_S = 60.0                # bound: kvd leader death -> meta reply
# heartbeats and mgmtd's tick: each is a transaction on the shared KV, and
# they contend on its routing version key
FLEET_BEAT_S = 1.0
# the inference host's hedge floor: a peerRead of one 2 MiB page over
# loopback TCP takes milliseconds, not the default 5 ms floor's budget
FLEET_HEDGE_MS = 250.0
# a peerRead's reply estimate a page (an encoded 2 MiB page is under it)
# and the peer clients' ring iov: the estimate is clamped to half the
# arena, so a 16-page reply (32 MiB) must fit in half of it, or it would
# overflow its region and quietly ride a socket
FLEET_PEER_EST = 2 * MIB + 4096
FLEET_PEER_IOV = 128 * MIB


def fleet_group_ports(n: int) -> list:
    """``n`` bindable ports below the kernel's ephemeral range: kvd group
    members restart on the fixed ports of their peer map, and an
    ephemeral source port could squat on a killed member's freed port."""
    import random

    ports = []
    rng = random.Random()
    while len(ports) < n:
        p = rng.randrange(20000, 30000)
        if p in ports:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", p))
            except OSError:
                continue
        ports.append(p)
    return ports


class FleetProcesses(SockProcesses):
    """Phase 18: the whole deployment as processes from their entry points
    (never forked): a kvd group of three (``kv_main --peers``, a data
    directory each, fsync on), ``monitor_main``, mgmtd and two meta
    servers on ``--kv`` the group (4 meta partitions), phase 17's four
    storage nodes and two ``serving_main`` processes with a 1 GiB host
    tier each; every process but the kvd members and the collector pushes
    its samples to the collector. The kvd group boots first and must show
    one leader before anything is started on it. The storage and serving
    processes run on the JAX package's defaults: each hosts USRBIO rings
    (``usrbio=1``) and rides them to its co-located peers (the serving
    processes' ``peer_usrbio=1``, with FLEET_PEER_EST and FLEET_PEER_IOV
    so that a 16-page peerRead fits its ring)."""

    env = {"TPU3FS_USRBIO": "1"}
    push_s = FLEET_PUSH_S

    def _boot(self) -> None:
        from tpu3fs_torch.rpc.services import MgmtdAdminRpcClient, MgmtdRpcClient

        t0 = time.perf_counter()
        kv_ports = fleet_group_ports(len(FLEET_KVD))
        self.kv_addrs = {n: ("127.0.0.1", p)
                         for n, p in zip(FLEET_KVD, kv_ports)}
        # with the members' ids: a hint names the leader by id
        self.kv_flag = ",".join(f"{n}={h}:{p}"
                                for n, (h, p) in self.kv_addrs.items())
        for node_id in FLEET_KVD:
            self._kvd(node_id)
        self.kv_leader()
        self.mon_addr = ("127.0.0.1", free_port())
        self._start("monitor", "monitor_main", FLEET_MONITOR, [
            "--port", str(self.mon_addr[1]),
            f"--config.out_path={self.logdir / 'samples.db'}"])
        port = free_port()
        self.maddr = ("127.0.0.1", port)
        self.admin = MgmtdAdminRpcClient(self.maddr)
        self.mgmtd_cli = MgmtdRpcClient(self.maddr)
        self._start("mgmtd", "mgmtd_main", SOCK_MGMTD, [
            "--port", str(port), "--kv", self.kv_flag,
            f"--config.meta_partitions={FLEET_PARTS}",
            f"--config.tick_interval_s={FLEET_BEAT_S}",
            "--config.heartbeat_timeout_s=5", *self.push()])
        sock_wait(lambda: self.admin.refresh_routing() is not None,
                  "mgmtd to answer")
        for node_id in SOCK_IDS:
            self._storage(node_id)
        for node_id in SOCK_IDS:
            self.registered(node_id)
        sock_layout(self.admin, SOCK_IDS)
        sock_wait(lambda: sock_serving(self.admin.refresh_routing()),
                  "every chain to serve")
        # one at a time: every registration bumps the routing version, one
        # hot key of the shared KV
        self.meta_addrs = []
        for node_id in FLEET_META:
            self._start(f"meta{node_id}", "meta_main", node_id, [
                "--mgmtd=%s:%d" % self.maddr, "--kv", self.kv_flag,
                "--meta-partitions", str(FLEET_PARTS),
                "--heartbeat_interval", str(FLEET_BEAT_S),
                "--config.gc_interval_s=1", *self.push()])
            node = self.registered(node_id)
            self.meta_addrs.append((node.host, node.port))

        def balanced():
            parts = self.admin.refresh_routing().meta_partitions
            owners = {row.node_id for row in parts.values()}
            return len(parts) == FLEET_PARTS and owners == set(FLEET_META)
        sock_wait(balanced, "both meta servers to own partitions")
        self.serving = {}
        for node_id in FLEET_SERVING:
            self._start(f"serving{node_id}", "serving_main", node_id, [
                "--mgmtd=%s:%d" % self.maddr,
                "--heartbeat_interval", str(FLEET_BEAT_S),
                f"--config.capacity_bytes={FLEET_TIER}",
                f"--config.dirty_max_bytes={FLEET_TIER}",
                f"--config.peer_est_bytes={FLEET_PEER_EST}",
                f"--config.peer_iov_bytes={FLEET_PEER_IOV}", *self.push()])
            self.serving[node_id] = sock_wait(
                lambda n=node_id: self.admin.refresh_routing().serving.get(n),
                f"serving {node_id} to register")
        self.boot_s = time.perf_counter() - t0

    def _storage(self, node_id: int) -> None:
        self._start(f"storage{node_id}", "storage_main", node_id, [
            "--mgmtd=%s:%d" % self.maddr,
            "--heartbeat_interval", str(FLEET_BEAT_S),
            f"--config.data_dir={self.data_dir(node_id)}",
            "--config.target_scan_interval_s=0.5",
            "--config.resync_interval_s=0.5", *self.push()])

    def _kvd(self, node_id: int) -> None:
        peers = ",".join(f"{n}={h}:{p}" for n, (h, p) in
                         self.kv_addrs.items())
        self._start(f"kvd{node_id}", "kv_main", node_id, [
            "--port", str(self.kv_addrs[node_id][1]), "--peers", peers,
            "--data-dir", str(self.logdir / f"kvd{node_id}"),
            "--fsync", "1"])

    def kv_status(self) -> dict:
        """node id -> StatusRsp of every member that answers."""
        from tpu3fs_torch.kv.replica import KV_REPL_SERVICE_ID, StatusReq, StatusRsp
        from tpu3fs_torch.rpc.net import RpcClient

        out = {}
        cli = RpcClient(connect_timeout=1.0, call_timeout=2.0)
        try:
            for n, addr in self.kv_addrs.items():
                try:
                    out[n] = cli.call(addr, KV_REPL_SERVICE_ID, 4,
                                      StatusReq(), StatusRsp)
                except Exception:
                    pass
        finally:
            cli.close()
        return out

    def kv_leader(self, exclude=()) -> int:
        """The one leader every answering member names (bounded wait)."""
        def one():
            st = {n: r for n, r in self.kv_status().items()
                  if n not in exclude}
            leaders = [n for n, r in st.items() if r.role == "leader"]
            if len(leaders) == 1 and len(st) >= 2 and all(
                    r.leader_id == leaders[0] for r in st.values()):
                return leaders[0]
            return None
        return sock_wait(one, "the kvd group to show one leader")

    def kill(self, name: str) -> None:
        self.sigkill([c for c in self.procs if c.name == name][-1])


def fleet_device_files(pid: int) -> dict:
    """What ties a process to the card: the card's device files it holds
    open or has mapped, and whether the built kernel library is mapped."""
    from tpu3fs_torch import kernels

    fds = set()
    for fd in Path(f"/proc/{pid}/fd").iterdir():
        try:
            fds.add(os.readlink(fd))
        except OSError:
            pass
    maps = Path(f"/proc/{pid}/maps").read_text()
    mapped = sorted({m for m in re.findall(r"/dev/nvidia[\w-]*", maps)})
    # the kernel library is libtpu3fs_torch_<digest>.so; the host
    # libraries beside it carry their name before the digest
    lib = re.escape(str(kernels.BUILD_DIR.resolve())) \
        + r"/libtpu3fs_torch_[0-9a-f]+\.so$"
    return {"open": sorted(f for f in fds if f.startswith("/dev/nvidia")),
            "mapped": mapped,
            "kernel_library": re.search(lib, maps, re.M) is not None}


def fleet_off_card(pids: list, on_pids: list) -> dict:
    """The kvd members and the collector hold no CUDA context. Asking
    whether a card exists (``--device cuda`` resolves through
    ``torch.cuda.is_available()``) opens and maps the card's control and
    device files; a context also maps ``/dev/nvidia-uvm``, which every
    process shown on the card (``on_pids``) must map and none of ``pids``
    may, nor the kernel library."""
    seen = {pid: fleet_device_files(pid) for pid in on_pids + pids}
    log(json.dumps({"device_files": seen}))
    for pid in on_pids:
        require("/dev/nvidia-uvm" in seen[pid]["mapped"],
                f"process {pid} is on the card but maps no unified "
                f"memory: {seen[pid]}")
    for pid in pids:
        require("/dev/nvidia-uvm" not in seen[pid]["mapped"]
                and not seen[pid]["kernel_library"],
                f"process {pid} (kvd or collector) holds a CUDA context: "
                f"{seen[pid]}")
    return {str(pid): seen[pid] for pid in pids + on_pids}


class FleetHost:
    """The inference host: this process. A ``PrefixBlockStore`` over a
    ``FleetKVCache`` on the card, on the deployment's meta (partition-
    routed) and storage; its peers are the serving processes the current
    step names, from mgmtd's serving directory, reached through a
    ``ServingPeerClient`` over USRBIO rings (the default, with an iov of
    FLEET_PEER_IOV) or, for the socket turns of the peer fill, one with
    ``usrbio=False``; the peer client in use is ``fleet.peers``."""

    def __init__(self, ctl: FleetProcesses, dev):
        from tpu3fs_torch.client.file_io import FileIoClient
        from tpu3fs_torch.client.hedging import HedgeController
        from tpu3fs_torch.client.storage_client import StorageClient
        from tpu3fs_torch.kvcache import KVCacheClient, PrefixBlockStore
        from tpu3fs_torch.rpc.health import HealthRegistry
        from tpu3fs_torch.rpc.net import RpcClient
        from tpu3fs_torch.rpc.services import MetaRpcClient, RpcMessenger
        from tpu3fs_torch.serving import FleetKVCache
        from tpu3fs_torch.serving.service import ServingPeerClient

        self.ctl = ctl
        routing = ctl.admin.refresh_routing
        self.meta = MetaRpcClient(ctl.meta_addrs, client_id="fleet-host",
                                  mgmtd=ctl.mgmtd_cli, nparts=FLEET_PARTS)
        self.sc = StorageClient("fleet-host", routing,
                                RpcMessenger(routing), device=dev)
        self.fio = FileIoClient(self.sc)
        self.kv = KVCacheClient(self.meta, self.fio, client_id="fleet-host",
                                inode_cache=4096)
        # a servingLoad leg is one call that runs the whole leg
        self.rpc = RpcClient(call_timeout=SOCK_WAIT_S)
        self.peer_clients = {
            "ring": ServingPeerClient(self.rpc, usrbio=True,
                                      iov_bytes=FLEET_PEER_IOV),
            "socket": ServingPeerClient(self.rpc, usrbio=False)}
        self.peers = self.peer_clients["ring"]
        self.view = SimpleNamespace(serving={})
        health = HealthRegistry()
        self.fleet = FleetKVCache(
            self.kv, node_id=FLEET_HOST, routing=lambda: self.view,
            peer_client=self.peers, health=health,
            hedge=HedgeController(health=health,
                                  delay_floor_ms=FLEET_HEDGE_MS),
            capacity_bytes=FLEET_TIER, dirty_max_bytes=FLEET_TIER,
            write_through=True, peer_est_bytes=FLEET_PEER_EST)
        self.store = PrefixBlockStore(self.fleet,
                                      block_tokens=KV_BLOCK_TOKENS)

    def peers_are(self, *node_ids) -> None:
        """The serving directory as mgmtd publishes it, cut to the step's
        peers."""
        serving = self.ctl.admin.refresh_routing().serving
        self.view.serving = {n: serving[n] for n in node_ids}

    def load(self, node_id: int, req):
        return self.peers.load(self.ctl.serving[node_id], req)

    def fetch(self, keys: list) -> None:
        """Fill the host tier in decode-step chunks (one peerRead, or one
        striped storage batch, of FLEET_BATCH pages each)."""
        for i in range(0, len(keys), FLEET_BATCH):
            got = self.fleet.batch_get(keys[i:i + FLEET_BATCH])
            require(all(v is not None for v in got),
                    f"a page of chunk {i // FLEET_BATCH} is missing")

    def close(self) -> None:
        self.fleet.close(flush=False)
        for peers in self.peer_clients.values():
            peers.close()
        self.fio.close()
        self.sc.close()
        self.rpc.close()


def fleet_check_blocks(name: str, got: list, want: list) -> None:
    """Every block on the sources' device, equal to its source there."""
    require(len(got) == len(want), f"{name}: {len(got)} blocks")
    for i, (blk, w) in enumerate(zip(got, want)):
        require(blk is not None and blk.device == w.device
                and blk.dtype == w.dtype and blk.shape == w.shape
                and torch.equal(blk.view(torch.int16), w.view(torch.int16)),
                f"{name}: block {i} differs, on the card, from the page "
                "that was put")


def fleet_failover(ctl: FleetProcesses, host: FleetHost) -> dict:
    """SIGKILL the kvd leader; meta creates and stats through all four
    partitions (both meta servers) go on once a new leader takes over,
    within FLEET_FAILOVER_S; the killed member restarts on its data
    directory and catches up to the leader's commit index."""
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.metashard.partition import partition_of_dir

    dirs, i = {}, 0
    while len(dirs) < FLEET_PARTS:
        d = f"/failover/d{i}"
        dirs.setdefault(partition_of_dir(d, FLEET_PARTS), d)
        i += 1
    for d in dirs.values():
        host.meta.mkdirs(d, recursive=True)
    leader = ctl.kv_leader()
    before = ctl.kv_status()[leader]
    t0 = time.perf_counter()
    ctl.kill(f"kvd{leader}")
    first = None
    deadline = time.monotonic() + FLEET_FAILOVER_S
    while first is None:
        try:
            host.meta.create(f"{dirs[0]}/first", flags=OpenFlags.WRITE
                             | OpenFlags.CREATE, client_id="fleet-host")
            first = time.perf_counter() - t0
        except Exception as e:
            require(time.monotonic() < deadline, "meta did not answer "
                    f"within {FLEET_FAILOVER_S:.0f} s of the kvd leader's "
                    f"death: {e!r}")
            time.sleep(0.05)
    ids = {}
    for pid, d in sorted(dirs.items()):
        for j in range(4):
            res = host.meta.create(f"{d}/f{j}", flags=OpenFlags.WRITE
                                   | OpenFlags.CREATE,
                                   client_id="fleet-host")
            st = host.meta.stat(f"{d}/f{j}")
            require(st.id == res.inode.id, f"{d}/f{j}: stat after create")
            ids[f"{d}/f{j}"] = st.id
    all_s = time.perf_counter() - t0
    require(all_s < FLEET_FAILOVER_S, f"the meta ops took {all_s:.1f} s")
    new_leader = ctl.kv_leader(exclude=(leader,))
    require(new_leader != leader, "the dead member still leads")
    ctl._kvd(leader)          # a new process on the same data directory
    target = ctl.kv_status()[new_leader].commit_index
    t1 = time.perf_counter()
    sock_wait(lambda: ctl.kv_status().get(leader) is not None and
              ctl.kv_status()[leader].commit_index >= target,
              f"kvd {leader} to catch up to index {target}")
    caught = time.perf_counter() - t1
    after = ctl.kv_status()
    return {"killed": leader, "new_leader": new_leader,
            "term": [before.term, after[new_leader].term],
            "first_meta_reply_s": first, "meta_ops_s": all_s,
            "partitions": sorted(dirs), "catch_up_s": caught,
            "catch_up_index": target,
            "restarted": vars(after[leader])}


def fleet_collector(ctl: FleetProcesses, legs: dict) -> dict:
    """``aggQuery`` answers the serving.* series of the serving processes
    with totals no lower than their legs' counter deltas, after two push
    periods; ``sloStatus`` answers."""
    from tpu3fs_torch.monitor.collector import (COLLECTOR_SERVICE_ID,
                                                AggQueryReq, AggQueryRsp,
                                                SloStatusReq, SloStatusRsp)
    from tpu3fs_torch.rpc.net import RpcClient

    want = {"serving.peer_miss": sum(r.peer_misses for r in legs.values()),
            "serving.fill_coalesced": sum(r.coalesced for r in legs.values())}
    cli = RpcClient()
    try:
        time.sleep(2.5 * FLEET_PUSH_S)

        def totals():
            rsp = cli.call(ctl.mon_addr, COLLECTOR_SERVICE_ID, 3,
                           AggQueryReq(name="serving.", prefix=True,
                                       window_s=3600.0), AggQueryRsp)
            got = collections.Counter()
            for row in rsp.rows:
                got[row.name] += row.vsum
            return got if all(got[k] >= v for k, v in want.items()) \
                else None
        got = sock_wait(totals, "the collector's serving.* totals", 60.0)
        slo = cli.call(ctl.mon_addr, COLLECTOR_SERVICE_ID, 4,
                       SloStatusReq(), SloStatusRsp)
    finally:
        cli.close()
    return {"serving_totals": dict(got), "leg_deltas": want,
            "slo_verdict": slo.verdict, "slo_rules": len(slo.rules)}


def fleet_peer_fill(host: FleetHost, dev, steps: dict, info: dict,
                    kind: str, turn: int, keys: list, toks: list,
                    shared: int, entry: int, want: list) -> None:
    """One turn of B's prefix peer-filled from 61 through the ``kind``
    peer client ("ring" or "socket"), then put on the card by
    ``get_blocks``: every page a peer hit and none a storage fill, every
    peerRead over ``kind`` alone, every block equal to its source."""
    from tpu3fs_torch.utils.bufpool import GLOBAL_POOL

    peers = host.peer_clients[kind]
    host.fleet.peers = peers
    host.fleet.tier.clear()
    host.peers_are(61)
    pool0 = GLOBAL_POOL.stats()["outstanding"]
    c0, calls0 = host.fleet.counters(), collections.Counter(
        peers.transport_calls)
    fill, card = f"fill_b_prefix_peer_{kind}{turn}", f"b_prefix_to_card_{kind}{turn}"

    def timed(name, fn, nbytes=0):
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        steps[name] = {"host_ms": ms}
        if nbytes:
            steps[name]["GiB_s"] = nbytes / (1 << 30) / (ms / 1e3)
        return out

    timed(fill, lambda: host.fetch(keys), shared * entry)
    got = timed(card, lambda: host.store.get_blocks(toks, count=shared,
                                                    device=dev))
    c1 = host.fleet.counters()
    hits = c1["peer_hits"] - c0["peer_hits"]
    require(hits == shared and c1["storage_fills"] == c0["storage_fills"],
            f"{fill}: {hits} peer hits of {shared}")
    require(GLOBAL_POOL.stats()["outstanding"] == pool0,
            "the receive pool kept a peer reply's buffer")
    calls = collections.Counter(peers.transport_calls) - calls0
    other = {k: v for k, v in calls.items() if k[0] != kind}
    require(calls and not other, f"{fill}: peerReads {dict(calls)} left the "
            f"{kind} transport")
    steps[fill]["peer_reads"] = sum(calls.values())
    fleet_check_blocks(fill, got, want)
    info.setdefault(f"prefix_on_card_{kind}", []).append(
        steps[fill]["host_ms"] + steps[card]["host_ms"])
    log(f"  {fill:<26} host {steps[fill]['host_ms']:10.1f} ms  "
        f"{steps[fill]['GiB_s']:.3f} GiB/s, on the card after "
        f"{info[f'prefix_on_card_{kind}'][-1]:.1f} ms")


def fleet(dev) -> dict:
    """Phase 18: the deployment as processes (FleetProcesses) with this
    script as the inference host (FleetHost), at phase 12's Llama-3.1-8B
    page shapes. The script's kernel counts are zeroed before its steps
    and read after (the checks' own launches taken out); every K1, K2 and
    K3 call counted must be a kernel launch, none a plain version. The
    serving and storage processes' launches are not visible here: each of
    those processes is shown on the card, and the kvd members and the
    collector shown off it. -> the script's launches."""
    import tempfile

    from tpu3fs_torch.kvcache.layout import encode_array, shard_path
    from tpu3fs_torch.serving.service import ServingLoadReq

    t_phase = phase("phase 18: the deployment as processes")
    pages, sources = kv_pages(dev)
    n_a, shared, own = FLEET_FULL
    bt = KV_BLOCK_TOKENS
    toks_a = list(range(n_a * bt))
    toks_b = toks_a[:shared * bt] + [10_000_000 + t for t in range(own * bt)]
    src_a = [sources[i] for i in range(n_a)]
    src_own = [sources[n_a + i] for i in range(own)]
    entry = len(encode_array(pages[0]))
    require(entry <= FLEET_PEER_EST, f"a page's entry is {entry} B")
    steps, legs, uncounted, info = {}, {}, collections.Counter(), {}
    info["shm"] = shm_fits("phase 18", clients=1 + len(FLEET_SERVING),
                           storage=len(SOCK_IDS),
                           peers=2 * len(FLEET_SERVING))
    ctl = host = None
    problems = []

    def step(name, fn, nbytes=0):
        c0, t0 = read_counts(), time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        c1 = read_counts()
        steps[name] = {"host_ms": ms, "launches": {
            k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}}
        if nbytes:
            steps[name]["GiB_s"] = nbytes / (1 << 30) / (ms / 1e3)
        log(f"  {name:<26} host {ms:10.1f} ms  launches "
            f"{steps[name]['launches']}")
        return out

    def leg(name, node_id, req, nbytes=0):
        rsp = step(name, lambda: host.load(node_id, req), nbytes)
        require(rsp.errors == 0 and rsp.ops == len(req.keys) * max(
            1, req.repeat), f"{name}: {rsp.ops} ops, {rsp.errors} errors")
        legs[name] = rsp
        if nbytes:
            steps[name]["serving_GiB_s"] = rsp.nbytes / (1 << 30) / max(
                rsp.wall_us / 1e6, 1e-9)
        steps[name]["reply"] = {k: v for k, v in vars(rsp).items()
                                if k != "lat_us"}
        return rsp

    def not_counted(fn):
        c0 = read_counts()
        out = fn()
        c1 = read_counts()
        uncounted.update({k: c1[k] - c0[k] for k in c1})
        return out

    with tempfile.TemporaryDirectory() as tmp:
        try:
            ctl = FleetProcesses(Path(tmp), "cuda" if dev.type == "cuda"
                                 else "cpu")
            log(f"  booted 13 processes in {ctl.boot_s:.1f} s")
            host = FleetHost(ctl, dev)
            keys_a = host.store.block_keys(toks_a)
            keys_b = host.store.block_keys(toks_b)
            load_keys = [f"fleet/load/{i}" for i in range(n_a)]
            zero_counts()
            # 1: serving process 61's write-through put leg, in decode-
            # step batches (its payload is the wire's constant bytes)
            leg("put_leg_61", 61, ServingLoadReq(
                op="put", keys=load_keys, value_bytes=entry,
                batch=FLEET_BATCH, write_through=True), n_a * entry)
            # 2: the host stores A's pages write-through (K1, K2 here)
            wrote = step("put_a_host", lambda: sum(
                host.store.append_blocks(
                    toks_a, pages[i:i + FLEET_BATCH], start_block=i,
                    write_through=True)
                for i in range(0, n_a, FLEET_BATCH)), n_a * entry)
            require(wrote == n_a, f"the host stored {wrote} of A's pages")
            # 3: serving process 61 fills its host tier with A: claimed
            # storage fills (no peer holds A)
            leg("fill_a_61_storage", 61, ServingLoadReq(
                op="get", keys=keys_a, batch=FLEET_BATCH), n_a * entry)
            require(legs["fill_a_61_storage"].storage_fills == n_a,
                    "61 did not fill A from storage")
            # 4: B's shared prefix onto the card, peer-filled from 61, in
            # turns over the ring peer client and a socket-only one; the
            # rings to both serving processes are made before the turns
            for node_id in FLEET_SERVING:
                require(host.peers._ring_for(ctl.serving[node_id])
                        is not None, f"no ring to serving {node_id}")
            for turn in range(FLEET_PEER_TURNS):
                for kind in (("ring", "socket") if turn % 2 == 0
                             else ("socket", "ring")):
                    fleet_peer_fill(host, dev, steps, info, kind, turn,
                                    keys_b[:shared], toks_b, shared, entry,
                                    src_a[:shared])
            host.fleet.peers = host.peers
            for kind in ("ring", "socket"):
                fills = [steps[f"fill_b_prefix_peer_{kind}{t}"]
                         for t in range(FLEET_PEER_TURNS)]
                info[f"peer_fill_{kind}"] = {
                    "GiB_s": med([f["GiB_s"] for f in fills]),
                    "prefix_on_card_ms": med(info[f"prefix_on_card_{kind}"])}
            # 5: B's own pages, write-through from the host (K1, K2 here)
            wrote = step("put_b_own_host", lambda: sum(
                host.store.append_blocks(
                    toks_b, pages[n_a + i:n_a + i + FLEET_BATCH],
                    start_block=shared + i, write_through=True)
                for i in range(0, own, FLEET_BATCH)), own * entry)
            require(wrote == own, f"the host stored {wrote} of B's pages")
            # 6: 62 puts a key write-through (K1, K2 in 62); K concurrent
            # misses of it in 62, whose host tier is dropped and whose peer
            # has never seen it, are one claimed storage fill; then 62
            # gets A with 61's
            # host tier dropped (61 still holds A's inodes, and serves a
            # peerRead through them when it answers within 62's deadline)
            leg("put_viral_62", 62, ServingLoadReq(
                op="put", keys=["fleet/viral"], value_bytes=entry,
                write_through=True), entry)
            leg("singleflight_62", 62, ServingLoadReq(
                op="get", keys=["fleet/viral"], concurrency=FLEET_SF_K,
                repeat=FLEET_SF_K, drop_host=True))
            require(legs["singleflight_62"].storage_fills == 1 and
                    legs["singleflight_62"].hits == FLEET_SF_K,
                    f"{FLEET_SF_K} concurrent misses of one key made "
                    f"{legs['singleflight_62'].storage_fills} storage fills")
            leg("drop_61", 61, ServingLoadReq(op="get", keys=[],
                                              drop_host=True))
            leg("fill_a_62", 62, ServingLoadReq(
                op="get", keys=keys_a, batch=FLEET_BATCH, drop_host=True),
                n_a * entry)
            r = legs["fill_a_62"]
            require(r.hits == n_a and r.storage_fills + r.peer_hits == n_a,
                    f"62's fills of A: {r}")
            # the stored shards of two of A's entries and one of the put
            # leg's, read back and held against twins encoded on the card
            routing = ctl.admin.refresh_routing()
            n_checked = 0
            for key, body in ((keys_a[0], encode_array(pages[0])),
                              (keys_a[n_a - 1], encode_array(pages[n_a - 1])),
                              (load_keys[7], b"\xa5" * entry)):
                inode = host.meta.stat(shard_path(host.kv.root, key))
                n_checked += not_counted(lambda: sock_shards(
                    host.sc, routing, inode, body, dev))
                require(not_counted(lambda: host.kv.get(key)) == body,
                        f"{key}: the stored entry differs")
            info["shards_checked"] = n_checked
            if dev.type == "cuda":
                on = ctl.pid_of("storage") + ctl.pid_of("serving")
                info["on_card"] = sock_on_card(on, ctl.device_files,
                                               device_work_nodes(ctl))
                info["off_card"] = fleet_off_card(
                    ctl.pid_of("kvd") + ctl.pid_of("monitor"),
                    [p for p in info["on_card"]["pids"] if p in on])
            # 7: a storage process dies; B's tail from storage, degraded
            # (K1 here), its prefix from 62's host tier
            ctl.fail(SOCK_IDS[-1])
            host.fleet.tier.clear()
            host.peers_are()
            step("fill_b_tail_degraded", lambda: host.fetch(
                keys_b[shared:]), own * entry)
            host.peers_are(62)
            step("fill_b_prefix_peer_62", lambda: host.fetch(
                keys_b[:shared]), shared * entry)
            got = step("b_to_card", lambda: host.store.get_blocks(
                toks_b, count=shared + own, device=dev))
            fleet_check_blocks("b_after_failure", got,
                               src_a[:shared] + src_own)
            del got
            # 8: the kvd leader dies; meta goes on after a new leader
            info["failover"] = step("kvd_failover",
                                    lambda: fleet_failover(ctl, host))
            counts = read_counts()
            # 9: the collector's rollups of the serving processes' pushes
            info["collector"] = fleet_collector(ctl, {
                k: legs[k] for k in ("fill_a_62", "singleflight_62")})
            info["serving_stats"] = {
                n: vars(host.peers.stats(ctl.serving[n]))
                for n in FLEET_SERVING}
        finally:
            if ctl is not None:
                ctl.snap_shm()
            if host is not None:
                host.close()
            if ctl is not None:
                problems = ctl.close()
                # after a failure too: a SIGKILLed child's leftovers go
                info["shm_cleanup"] = ctl.shm.cleanup()
        require(not problems, f"phase 18: {problems}")
    held = info["shm_cleanup"]["still_held"]
    require(not held, f"phase 18: /dev/shm still holds {held} of its "
            "processes")
    counts = {n: c - uncounted[n] for n, c in counts.items()}
    require_main_path("the deployment as processes", counts,
                      ("gf2_matmul", "crc32c_blocks"))
    e2e = {
        "put_leg_61_GiB_s": steps["put_leg_61"]["serving_GiB_s"],
        "put_host_GiB_s": steps["put_a_host"]["GiB_s"],
        "peer_fill_ring_GiB_s": info["peer_fill_ring"]["GiB_s"],
        "peer_fill_socket_GiB_s": info["peer_fill_socket"]["GiB_s"],
        "peer_fill_ring_over_socket": info["peer_fill_ring"]["GiB_s"]
        / info["peer_fill_socket"]["GiB_s"],
        "storage_fill_61_GiB_s":
            steps["fill_a_61_storage"]["serving_GiB_s"],
        "fill_a_62_GiB_s": steps["fill_a_62"]["serving_GiB_s"],
        "degraded_fill_GiB_s": steps["fill_b_tail_degraded"]["GiB_s"],
        "prefix_on_card_ring_ms":
            info["peer_fill_ring"]["prefix_on_card_ms"],
        "prefix_on_card_socket_ms":
            info["peer_fill_socket"]["prefix_on_card_ms"],
        "failover_first_meta_reply_s":
            info["failover"]["first_meta_reply_s"],
        "boot_s": ctl.boot_s}
    log(json.dumps({"fleet": e2e, "steps": steps, "info": info,
                    "launches": counts, "card": card_line(),
                    "seconds": time.perf_counter() - t_phase},
                   default=str))
    log(f"fleet: launches {counts} ({time.perf_counter() - t_phase:.1f} s)")
    return {n: counts[n] for n in counters()}


# -- phase 19 ----------------------------------------------------------------
# phase 19's turns of each request on each client: 3 until phase 23 was
# added, 1 since (ring first), for the script's time limit
RING_TURNS = 1
# phase 18's rotated peer-fill turns over the ring and the socket client
# (3 until phase 23 was added)
FLEET_PEER_TURNS = 2
RING_CHUNKS = 32               # usrbio_bench's batch: 32 chunks of 1 MiB
# fio_usrbio's seq-write and seq-read shape, 1 MiB blocks at depth 32, on
# a 256 MiB file, not 1 GiB: the agent syncs the file's length with meta
# after every block written, and meta asks every chain for its last
# chunk, so a block costs more the longer the file (on an H100 machine a
# 1 GiB pass took over 800 s); 2 turns on each client, not RING_TURNS:
# 3 turns at 256 MiB took 122 s of the phase on the C++ engine, which
# left the script over its 900 s; 128 MiB since phase 21 was added, for
# the same limit; 1 turn since phase 23 was added
RING_API_MIB, RING_API_DEPTH, RING_API_TURNS = 128, 32, 1
RING_API_POOL = 64             # distinct 1 MiB source blocks of the API file
# the loader's epochs read 2 of phase 13's 4 record files (2,048 of 4,096
# records), for the script's time limit
RING_LOADER_FILES = 2
RING_ROUTING_TTL_S = 0.5       # both clients' routing cache
RING_IOV_MIB = 64              # a messenger's ring iov (TPU3FS_USRBIO_IOV_MB)
SHM_DIR = "/dev/shm"
SHM_PREFIXES = ("tpu3fs-iov-", "tpu3fs-ior-", "tpu3fs-hs-", "sem.tpu3fs-ior-")


def shm_line() -> str:
    """/dev/shm's size and free space, and the library that resolved the
    named semaphores' ``sem_open``."""
    from tpu3fs_torch.usrbio import sem

    st = os.statvfs(SHM_DIR)
    return (f"/dev/shm {st.f_blocks * st.f_frsize >> 20} MiB, "
            f"{st.f_bavail * st.f_frsize >> 20} MiB free; sem_open from "
            f"{sem.LIBRARY}")


def shm_fits(what: str, clients: int, storage: int, peers: int = 0,
             extra_mib: int = 0) -> dict:
    """The rings' /dev/shm footprint at most: a client messenger maps one
    RING_IOV_MIB iov a storage node, a storage process's two messengers
    (forwards and resync) one a node each, a peer client one a serving
    peer (``peers`` of them, FLEET_PEER_IOV each), every page touched at
    setup. A footprint that does not fit /dev/shm's free space fails here
    with a message: a page past tmpfs's limit is a SIGBUS."""
    st = os.statvfs(SHM_DIR)
    free = st.f_bavail * st.f_frsize >> 20
    need = ((clients + 2 * storage) * len(SOCK_IDS) * RING_IOV_MIB
            + peers * (FLEET_PEER_IOV >> 20) + extra_mib)
    require(need <= free, f"{what}: the rings need up to {need} MiB of "
            f"/dev/shm and {free} MiB are free; give the machine a larger "
            "/dev/shm or lower TPU3FS_USRBIO_IOV_MB")
    return {"need_mib": need, "free_mib": free}


class ShmLedger:
    """The /dev/shm names of one phase's own processes, the script and its
    children. /dev/shm is the machine's, shared with whatever else runs
    there (another checkout's tests or script), so a phase reaps and
    checks only what its own processes mapped (``/proc/<pid>/maps``:
    rings, iovs and the rings' semaphores), read at each ``snap``, and
    the handshake nonce files named after its own pids."""

    def __init__(self):
        self.maps = collections.defaultdict(set)  # pid -> names it mapped
        self.owner = {}      # ring -> the owner pid its header stamps
        self.killed = set()  # pids SIGKILLed on purpose

    def snap(self, pids) -> None:
        for pid in pids:
            try:
                text = Path(f"/proc/{pid}/maps").read_text()
            except OSError:
                continue  # exited
            for name in re.findall(r"/dev/shm/(\S+)", text):
                if name.startswith(SHM_PREFIXES):
                    self.maps[pid].add(name)
                    if name.startswith("tpu3fs-ior-") \
                            and name not in self.owner:
                        self._read_owner(name)

    def _read_owner(self, ring: str) -> None:
        from tpu3fs_torch.usrbio.ring import _HDR

        try:
            with open(os.path.join(SHM_DIR, ring), "rb") as f:
                self.owner[ring] = _HDR.unpack(f.read(_HDR.size))[-1]
        except (OSError, struct.error):
            pass

    def cleanup(self) -> dict:
        """After the phase (every child stopped, the script's clients
        closed): the leftovers of the processes SIGKILLed on purpose are
        reaped (a ring whose header names a killed owner, with its two
        semaphores; a nonce file named after a killed pid; an iov a killed
        process mapped and the script never did, since the script's own
        are its clients' and unlinked when they close), and no other name
        of the phase's processes may remain: -> the counts and the names
        ``still_held``, which the phase requires empty."""
        from tpu3fs_torch.usrbio.ring import HS_PREFIX

        def hs_pid(name):
            try:
                return int(name[len(HS_PREFIX):].split("-", 1)[0])
            except ValueError:
                return None

        ours = set().union(*self.maps.values()) if self.maps else set()
        rings = {n for n in ours if n.startswith("tpu3fs-ior-")}
        ours |= {f"sem.{r}-{q}" for r in rings for q in ("sq", "cq")}
        present = {n for n in os.listdir(SHM_DIR)
                   if n.startswith(SHM_PREFIXES)}
        pids = set(self.maps) | self.killed
        ours |= {n for n in present
                 if n.startswith(HS_PREFIX) and hs_pid(n) in pids}
        script = self.maps[os.getpid()]
        by_killed = set().union(*(self.maps[p] for p in self.killed)) \
            if self.killed else set()
        left, reaped = sorted(ours & present), []
        for name in left:
            if name.startswith("tpu3fs-ior-") and name not in self.owner:
                self._read_owner(name)
            if name.startswith("sem."):
                reap = self.owner.get(name[4:-3]) in self.killed
            elif name.startswith("tpu3fs-ior-"):
                reap = self.owner.get(name) in self.killed
            elif name.startswith(HS_PREFIX):
                reap = hs_pid(name) in self.killed
            else:
                reap = name in by_killed and name not in script
            if reap:
                try:
                    os.unlink(os.path.join(SHM_DIR, name))
                    reaped.append(name)
                except FileNotFoundError:
                    pass
        after = sorted(n for n in ours if os.path.exists(
            os.path.join(SHM_DIR, n)))
        return {"names_of_the_phase": len(ours), "left": len(left),
                "reaped": len(reaped), "still_held": after}


def transport_calls(messenger) -> collections.Counter:
    """(transport, method) -> data-plane calls the messenger issued."""
    out = collections.Counter()
    for (transport, method, _), n in list(messenger.transport_calls.items()):
        out[(transport, method)] += n
    return out


def require_transport(what: str, before, after, transport: str) -> dict:
    """Every data-plane call between the two counts rode ``transport``,
    and there was at least one."""
    delta = after - before
    other = {k: v for k, v in delta.items() if k[0] != transport}
    require(not other, f"{what}: {other} left the {transport} transport")
    n = sum(delta.values())
    require(n > 0, f"{what}: no data-plane call was issued")
    return {f"{m}": v for (_, m), v in sorted(delta.items())}


class RingProcesses(SockProcesses):
    """Phase 19: phase 17 (b)'s cluster with the storage processes on the
    JAX package's default ``usrbio=1`` (each hosts rings, and its own
    messengers ride rings to the other storage processes); the samples
    each pushes to the collector carry its ``usrbio.completed`` and
    ``usrbio.bytes``."""

    env = {"TPU3FS_USRBIO": "1"}

    def _storage(self, node_id: int) -> None:
        self._start(f"storage{node_id}", "storage_main", node_id, [
            "--mgmtd=%s:%d" % self.maddr, "--heartbeat_interval", "0.5",
            f"--config.data_dir={self.data_dir(node_id)}",
            "--config.target_scan_interval_s=0.5",
            "--config.resync_interval_s=0.5", *self.push()])

    def fail(self, node_id: int) -> None:
        super().fail(node_id)
        time.sleep(RING_ROUTING_TTL_S)  # the clients' routing caches

    def restart(self, node_id: int, keep_data: bool = False) -> None:
        super().restart(node_id, keep_data)
        time.sleep(RING_ROUTING_TTL_S)


class RingSide:
    """One of phase 19's two clients over the same processes: the ring
    client (``TPU3FS_USRBIO=1``) or the socket client (``0``), each read
    when its messenger is built. A ``StorageClient`` on ``dev`` over a
    TTL-cached routing (``RING_ROUTING_TTL_S``), its ``FileIoClient`` and a
    ``MetaRpcClient``."""

    def __init__(self, ctl, dev, rings: bool):
        from unittest import mock

        from tpu3fs_torch.client.file_io import FileIoClient
        from tpu3fs_torch.client.storage_client import StorageClient
        from tpu3fs_torch.rpc.services import (MetaRpcClient, MgmtdRpcClient,
                                               RpcMessenger)

        self.name = "ring" if rings else "socket"
        self.routing = MgmtdRpcClient(
            ctl.maddr, routing_ttl_s=RING_ROUTING_TTL_S).refresh_routing
        with mock.patch.dict(os.environ,
                             {"TPU3FS_USRBIO": "1" if rings else "0"}):
            self.messenger = RpcMessenger(self.routing)
        self.sc = StorageClient(f"smoke-{self.name}", self.routing,
                                self.messenger, device=dev)
        self.fio = FileIoClient(self.sc)
        self.meta = MetaRpcClient([ctl.meta_addr],
                                  client_id=f"smoke-{self.name}")

    def connect(self) -> None:
        """The ring client's rings to every storage node, made one at a
        time before any request (concurrent first calls to one node ride
        sockets while its handshake runs, as in the JAX package)."""
        if self.name == "ring":
            for node_id in SOCK_IDS:
                require(self.messenger._ring_for(node_id) is not None,
                        f"no ring to storage node {node_id}")

    def calls(self) -> collections.Counter:
        return transport_calls(self.messenger)

    def ring_counts(self, node_id: int) -> tuple:
        """(completions, bytes moved) of this client's ring to the node."""
        ring = self.messenger._usrbio_rings.get(node_id)
        return (ring.completions, ring.bytes_moved) if ring else (0, 0)

    def close(self) -> None:
        self.fio.close()
        self.sc.close()


def ring_turns(sides: dict, fn, turns: int = RING_TURNS) -> dict:
    """``fn(side, turn)`` on both clients, ``turns`` turns, the order
    rotated each turn (ring first, then socket first, ...); every call of
    the ring client must ride rings only, every call of the socket client
    sockets only. -> client name -> [fn's result a turn]."""
    out = {"ring": [], "socket": []}
    for turn in range(turns):
        order = ("ring", "socket") if turn % 2 == 0 else ("socket", "ring")
        for name in order:
            side = sides[name]
            before = side.calls()
            out[name].append(fn(side, turn))
            require_transport(f"{name} client, turn {turn}", before,
                              side.calls(), name)
    return out


def med(values) -> float:
    return float(np.median(values))


def ring_ratio(rows: dict, key: str) -> dict:
    """Medians of ``key`` over the turns of each client, and ring/socket."""
    ring = med([r[key] for r in rows["ring"]])
    sock = med([r[key] for r in rows["socket"]])
    return {"ring": ring, "socket": sock,
            "ring_over_socket": ring / sock if sock else None}


def ring_bench(sides: dict) -> dict:
    """usrbio_bench's shape on the CR chain: ``batch_write`` then
    ``batch_read`` of 32 chunks of 1 MiB, then 32 single ``write_chunk``
    and ``read_chunk`` calls; every byte read checked."""
    from tpu3fs_torch.storage.craq import ReadReq
    from tpu3fs_torch.storage.types import ChunkId

    rng = np.random.default_rng(1919)
    data = [rng.integers(0, 256, MIB, dtype=np.uint8).tobytes()
            for _ in range(RING_CHUNKS)]
    gib = RING_CHUNKS * MIB / (1 << 30)

    def run(side, turn):
        fid = 19_000 + 10 * turn + (side.name == "socket")
        sc, row = side.sc, {}
        writes = [(SOCK_CR_CHAIN, ChunkId(fid, i), 0, data[i])
                  for i in range(RING_CHUNKS)]
        t0 = time.perf_counter()
        got = sc.batch_write(writes, chunk_size=MIB)
        row["batch_write_s"] = time.perf_counter() - t0
        require(all(r.ok for r in got), f"{side.name}: a batch write failed")
        t0 = time.perf_counter()
        got = sc.batch_read([ReadReq(SOCK_CR_CHAIN, ChunkId(fid, i), 0, -1)
                             for i in range(RING_CHUNKS)])
        row["batch_read_s"] = time.perf_counter() - t0
        require([bytes(r.data) for r in got] == data,
                f"{side.name}: the batch read's bytes differ")
        del got
        t0 = time.perf_counter()
        for i in range(RING_CHUNKS):
            require(sc.write_chunk(SOCK_CR_CHAIN, ChunkId(fid + 5, i), 0,
                                   data[i], chunk_size=MIB).ok,
                    f"{side.name}: a single write failed")
        row["write_op_ms"] = (time.perf_counter() - t0) * 1e3 / RING_CHUNKS
        t0 = time.perf_counter()
        for i in range(RING_CHUNKS):
            r = sc.read_chunk(SOCK_CR_CHAIN, ChunkId(fid + 5, i))
            require(r.ok and bytes(r.data) == data[i],
                    f"{side.name}: a single read's bytes differ")
        row["read_op_ms"] = (time.perf_counter() - t0) * 1e3 / RING_CHUNKS
        row["batch_write_GiB_s"] = gib / row["batch_write_s"]
        row["batch_read_GiB_s"] = gib / row["batch_read_s"]
        return row

    rows = ring_turns(sides, run)
    return {"turns": rows, **{k: ring_ratio(rows, k) for k in (
        "batch_write_GiB_s", "batch_read_GiB_s", "write_op_ms",
        "read_op_ms")}}


def ring_files(ctl, sides: dict, dev, inputs: dict, uncounted,
               collector) -> dict:
    """Phase 17's file requests: /a (48 RS(12,4) stripes of 1 MiB) written
    and read by each client in turns; the first storage process SIGKILLed
    and every file read degraded (K1 decodes here); a new process on empty
    targets, rebuilt by the storage processes over their own rings; every
    file read again, and a sample of stored shards held against twins
    encoded on the card. The storage processes' own data-plane calls by
    transport during the rebuild (their ``usrbio.calls_*`` pushes) show
    how much of it rode rings."""
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.storage.craq import ReadReq
    from tpu3fs_torch.storage.types import ChunkId

    body = inputs["a"]
    mib = len(body) / MIB
    files = {}

    def write_read(side, turn):
        path = f"/rings/{side.name}{turn}"
        res = side.meta.create(path, flags=OpenFlags.WRITE
                               | OpenFlags.CREATE, client_id=side.meta.client_id)
        t0 = time.perf_counter()
        side.fio.write(res.inode, 0, body)
        w = time.perf_counter() - t0
        inode = side.meta.close(res.inode.id, res.session_id)
        files[path] = inode
        t0 = time.perf_counter()
        got = side.fio.read(inode, 0, len(body))
        r = time.perf_counter() - t0
        require(got == body, f"{path}: the bytes read differ")
        return {"write_MiB_s": mib / w, "read_MiB_s": mib / r}

    def degraded(side, turn):
        inode = files[f"/rings/{side.name}{turn}"]
        t0 = time.perf_counter()
        got = side.fio.read(inode, 0, len(body))
        r = time.perf_counter() - t0
        require(got == body, f"{side.name}{turn}: the degraded bytes differ")
        return {"degraded_MiB_s": mib / r}

    sides["ring"].meta.mkdirs("/rings", recursive=True)
    rows = ring_turns(sides, write_read)
    victim = SOCK_IDS[0]
    ctl.fail(victim)
    deg = ring_turns(sides, degraded)
    split0 = collector.settled()
    ctl.restart(victim)
    t0 = time.perf_counter()
    ctl.rebuild()
    rebuild_s = time.perf_counter() - t0
    split1 = collector.settled()
    # the victim's shards of every file, read back from it over a ring
    ring = sides["ring"]
    ring.connect()
    r = ring.routing()
    reqs = []
    for inode in files.values():
        for i in range(-(-len(body) // MIB)):
            chain = r.chains[inode.layout.chain_of_chunk(i)]
            for t in chain.targets:
                if r.targets[t.target_id].node_id == victim:
                    reqs.append(ReadReq(chain.chain_id, ChunkId(inode.id, i),
                                        target_id=t.target_id))
    calls0 = ring.calls()
    replies = read_shards(ring.sc, victim, reqs)
    require(all(rp.ok for rp in replies), "a rebuilt shard is unreadable")
    lost = sum(len(rp.data) for rp in replies)
    del replies

    def reread(side, turn):
        path = f"/rings/{side.name}{turn}"
        t0 = time.perf_counter()
        got = side.fio.read(files[path], 0, len(body))
        require(got == body, f"{path}: the bytes after the rebuild differ")
        return {"read_after_rebuild_MiB_s": mib / (time.perf_counter() - t0)}

    after = ring_turns(sides, reread)
    c0 = read_counts()
    shards = sock_shards(ring.sc, ring.routing(), files["/rings/ring0"],
                         body, dev)
    c1 = read_counts()
    uncounted.update({k: c1[k] - c0[k] for k in c1})
    require_transport("the shard reads of the ring client", calls0,
                      ring.calls(), "ring")
    for key, turns in deg.items():
        for row, d in zip(rows[key], turns):
            row.update(d)
    return {"turns": rows, "read_after_rebuild": ring_ratio(
                after, "read_after_rebuild_MiB_s"),
            **{k: ring_ratio(rows, k) for k in (
                "write_MiB_s", "read_MiB_s", "degraded_MiB_s")},
            "rebuild": {"s": rebuild_s, "lost_bytes": lost,
                        "lost_shards": len(reqs),
                        "MiB_s": lost / MIB / rebuild_s,
                        "storage_process_calls": {
                            k: split1[k] - split0[k] for k in (
                                "usrbio.calls_ring", "usrbio.calls_socket",
                                "usrbio.completed", "usrbio.bytes")}},
            "shards_checked": shards}


class RingCollector:
    """The collector of RingProcesses: the usrbio.* totals every storage
    process pushed (``aggQuery``, one row a name: the recorders carry no
    node tag), read once two reads a push period apart agree."""

    NAMES = ("usrbio.completed", "usrbio.bytes", "usrbio.calls_ring",
             "usrbio.calls_socket")
    PREFIXES = ("usrbio.",)

    def __init__(self, ctl):
        from tpu3fs_torch.rpc.net import RpcClient

        self.addr, self.cli = ctl.mon_addr, RpcClient()

    def totals(self) -> dict:
        from tpu3fs_torch.monitor.collector import (COLLECTOR_SERVICE_ID,
                                                    AggQueryReq, AggQueryRsp)

        got = collections.Counter()
        for prefix in self.PREFIXES:
            rsp = self.cli.call(self.addr, COLLECTOR_SERVICE_ID, 3,
                                AggQueryReq(name=prefix, prefix=True,
                                            window_s=3600.0), AggQueryRsp)
            for row in rsp.rows:
                got[row.name] += row.vsum
        return {n: int(got[n]) for n in self.NAMES}

    def settled(self) -> dict:
        prev = None
        deadline = time.monotonic() + 60.0
        while True:
            time.sleep(2.5 * SOCK_PUSH_S)
            cur = self.totals()
            if cur == prev:
                return cur
            require(time.monotonic() < deadline,
                    "the collector's usrbio totals never settled")
            prev = cur

    def close(self) -> None:
        self.cli.close()


def ring_recorders(sides: dict, inputs: dict, collector) -> dict:
    """Each storage process's own ``usrbio.completed`` and ``usrbio.bytes``
    (its pushes, summed by the collector) against the ring client's
    counts: one window a node, in which only the ring client calls it
    (the node's shards of a file over ``batchReadRebuild``); a window
    opens and closes on settled totals."""
    from tpu3fs_torch.storage.craq import ReadReq
    from tpu3fs_torch.storage.types import ChunkId

    ring = sides["ring"]
    inode = ring.meta.stat(f"/rings/ring{RING_TURNS - 1}")  # the last turn's
    r = ring.routing()
    out = {}
    t0 = collector.settled()
    for node_id in SOCK_IDS:
        reqs = []
        for i in range(-(-len(inputs["a"]) // MIB)):
            chain = r.chains[inode.layout.chain_of_chunk(i)]
            for t in chain.targets:
                if r.targets[t.target_id].node_id == node_id:
                    reqs.append(ReadReq(chain.chain_id, ChunkId(inode.id, i),
                                        target_id=t.target_id))
        c0, calls0 = ring.ring_counts(node_id), ring.calls()
        replies = read_shards(ring.sc, node_id, reqs)
        require(all(rp.ok for rp in replies), f"node {node_id}: a shard "
                "read failed")
        del replies
        require_transport(f"node {node_id}'s window", calls0, ring.calls(),
                          "ring")
        c1 = ring.ring_counts(node_id)
        t1 = collector.settled()
        client = (c1[0] - c0[0], c1[1] - c0[1])
        host = (t1["usrbio.completed"] - t0["usrbio.completed"],
                t1["usrbio.bytes"] - t0["usrbio.bytes"])
        out[node_id] = {"client": client, "storage_process": host}
        require(client[0] > 0 and host == client, f"node {node_id}: the "
                f"storage process counted (completed, bytes) {host}, the "
                f"ring client {client}")
        t0 = t1
    return out


def ring_loader(ctl, sides: dict, dev, data: dict, mesh,
                stall: dict) -> dict:
    """Phase 16's loader over each client: the first RING_LOADER_FILES of
    phase 13's 4 record files packed once (over the ring client), then one
    shuffled,
    CRC-verified epoch at depth 4 with 1, 2 and 4 fetch workers, each
    client in turns; every batch a DTensor on the card equal to its
    records, every epoch the same (epoch, step, ids)."""
    from tpu3fs_torch.client.file_io import FileIoClient
    from tpu3fs_torch.dataload import (DataLoader, LoaderConfig,
                                       PackedDataset, RecordFileWriter)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tokens = data["tokens"]
    ring = sides["ring"]
    ring.meta.mkdirs("/rdata", recursive=True)
    per = data["records"] // data["files"]
    records = per * RING_LOADER_FILES
    paths = [f"/rdata/tokens{i}.rec" for i in range(RING_LOADER_FILES)]
    t0 = time.perf_counter()
    for i, path in enumerate(paths):
        w = RecordFileWriter(ring.meta, ring.fio, path, num_records=per)
        for rec in data["host"][i * per:(i + 1) * per]:
            w.append(rec)
        w.commit()
    pack_s = time.perf_counter() - t0
    cfg = dict(global_batch=data["batch"], seed=5, dtype="<i4",
               sample_shape=(SEQ_TOKENS,), depth=FETCH_DEPTH, epochs=1)
    first = {}

    def check(b):
        local = b.data.to_local()
        require(isinstance(b.data, DTensor) and tuple(b.data.shape)
                == (data["batch"], SEQ_TOKENS)
                and b.data.placements == (Shard(0), Replicate())
                and torch.equal(local, tokens[torch.tensor(
                    b.ids, device=tokens.device)]),
                f"batch {b.step}: its tokens differ from the records")
        return (b.epoch, b.step, b.ids)

    def epoch(side, workers, key):
        fio = FileIoClient(side.sc)
        try:
            ds = PackedDataset(side.meta, fio, paths)
            t0 = time.perf_counter()
            with DataLoader(ds, LoaderConfig(workers=workers, **cfg),
                            mesh=mesh) as ld:
                got = [check(b) for b in ld]
                (stall[key],) = ld._stall_ms.collect(0.0)
            s = time.perf_counter() - t0
        finally:
            fio.close()
        require_no_workers(key)
        first.setdefault("epoch", got)
        require(got == first["epoch"], f"{key}: its batches differ")
        return s

    def run(side, turn):
        return {f"w{w}_samples_s": records / epoch(
            side, w, f"{side.name}_w{w}_{turn}") for w in (1, 2, 4)}

    rows = ring_turns(sides, run)
    ids = sorted(i for _, _, b in first["epoch"] for i in b)
    require(ids == list(range(records)),
            "the epoch did not cover every record once")
    return {"pack_s": pack_s, "records": records, "turns": rows,
            **{k: ring_ratio(rows, k) for k in (
                "w1_samples_s", "w2_samples_s", "w4_samples_s")},
            "w4_over_w1": {n: med([r["w4_samples_s"] / r["w1_samples_s"]
                                   for r in rows[n]]) for n in rows}}


def api_block(pool: np.ndarray, i: int) -> np.ndarray:
    """Block ``i`` of the API file: source block ``i % RING_API_POOL``
    with its first 8 bytes replaced by ``i``."""
    b = pool[i % RING_API_POOL].copy()
    b[:8] = np.frombuffer(np.uint64(i).tobytes(), np.uint8)
    return b


def api_pass(client, path: str, pool: np.ndarray, write: bool) -> float:
    """``RING_API_MIB`` blocks of 1 MiB through the ``hf3fs_usrbio`` API at
    depth RING_API_DEPTH: ``iovcreate``, ``iorcreate``, ``reg_fd``, then
    ``prep_io`` into each free slot, ``submit_ios`` and ``wait_for_ios``
    until every block is done; a write stages each block into its slot, a
    read checks each block against its source as it completes. ->
    seconds from the first prep to the last completion."""
    n = RING_API_MIB
    iov = client.iovcreate(RING_API_DEPTH * MIB)
    ring = client.iorcreate(2 * RING_API_DEPTH, [iov], for_read=not write)
    view = np.frombuffer(iov.buf, np.uint8)
    fd = client.reg_fd(path, write=write)
    try:
        free, nxt, done = list(range(RING_API_DEPTH)), 0, 0
        slot_of = {}
        t0 = time.perf_counter()
        while done < n:
            while free and nxt < n:
                slot = free.pop()
                off = slot * MIB
                if write:
                    view[off:off + MIB] = api_block(pool, nxt)
                client.prep_io(ring, iov, off, MIB, fd, nxt * MIB,
                               read=not write, userdata=nxt)
                slot_of[nxt] = slot
                nxt += 1
            client.submit_ios(ring)
            for res, blk in client.wait_for_ios(ring, 1, timeout=120):
                require(res == MIB, f"{path}: block {blk} completed {res}")
                slot = slot_of.pop(blk)
                if not write:
                    off = slot * MIB
                    require(np.array_equal(view[off:off + MIB],
                                           api_block(pool, blk)),
                            f"{path}: block {blk} differs from its source")
                free.append(slot)
                done += 1
        s = time.perf_counter() - t0
    finally:
        client.dereg_fd(fd, length_hint=n * MIB if write else None)
        del view
        client.iordestroy(ring)
        client.iovdestroy(iov)
    return s


def ring_api(sides: dict) -> tuple:
    """The ``hf3fs_usrbio`` API: a ``UsrbioAgent`` in this process over
    each client's ``FileIoClient`` and meta, a ``UsrbioClient`` on it; a
    RING_API_MIB file written sequentially in 1 MiB blocks at depth 32
    (the fio_usrbio seq-write shape) and read back the same way, each
    client in RING_API_TURNS turns, every block checked against its source. A turn's
    files are removed after it, but the last turn's (read again later,
    degraded: ``ring_api_degraded``): the agent's per-block length sync
    scans every chunk of a target, so files left behind would slow the
    later turns. -> (the leg's record, the agents and clients)."""
    from tpu3fs_torch.usrbio import UsrbioAgent, UsrbioClient

    rng = np.random.default_rng(1920)
    pool = rng.integers(0, 256, (RING_API_POOL, MIB), dtype=np.uint8)
    gib = RING_API_MIB / 1024
    agents = {n: UsrbioAgent(s.meta, s.fio, client_id=f"usrbio-{n}")
              for n, s in sides.items()}
    api = SimpleNamespace(pool=pool, agents=agents, clients={
        n: UsrbioClient(a) for n, a in agents.items()})
    sides["ring"].meta.mkdirs("/api", recursive=True)

    def run(side, turn):
        path = f"/api/{side.name}{turn}"
        w = api_pass(api.clients[side.name], path, pool, True)
        require(side.meta.stat(path).length == RING_API_MIB * MIB,
                f"{path}: its length")
        r = api_pass(api.clients[side.name], path, pool, False)
        if turn < RING_API_TURNS - 1:
            side.meta.remove(path)
        return {"seq_write_GiB_s": gib / w, "seq_read_GiB_s": gib / r}

    try:
        rows = ring_turns(sides, run, RING_API_TURNS)
    except BaseException:
        ring_api_close(api)
        raise
    return {"turns": rows, **{k: ring_ratio(rows, k) for k in (
        "seq_write_GiB_s", "seq_read_GiB_s")}}, api


def ring_api_degraded(ctl, sides: dict, api) -> dict:
    """The second storage process SIGKILLed; each client's last API file
    read again through the API (degraded: K1 decodes here), in the order
    of the last turn."""
    gib = RING_API_MIB / 1024
    ctl.fail(SOCK_IDS[1])
    last = RING_API_TURNS - 1
    out = {}
    for name in ("ring", "socket") if last % 2 == 0 else ("socket", "ring"):
        side = sides[name]
        before = side.calls()
        out[name] = gib / api_pass(api.clients[name], f"/api/{name}{last}",
                                   api.pool, False)
        require_transport(f"{name} degraded API read", before, side.calls(),
                          name)
    out["ring_over_socket"] = out["ring"] / out["socket"]
    return out


def ring_api_close(api) -> None:
    for agent in api.agents.values():
        agent.stop()


def rings(dev, full: dict) -> dict:
    """Phase 19: the USRBIO rings between processes. Phase 17 (b)'s
    cluster (RingProcesses) with a ring client and a socket client over
    the same processes, every request on both in rotated turns: the
    usrbio_bench shape, phase 17's file requests with a SIGKILL, the
    rebuild and the storage processes' recorders against the client's
    counts, phase 16's loader at 1, 2 and 4 workers, and the hf3fs_usrbio
    API on a RING_API_MIB file. Every byte is checked; every ring call of the
    ring client rides a ring and every call of the socket client a
    socket; K1 and K2 launch here as tensor-core kernels, no plain
    version; no segment or semaphore is left in /dev/shm. -> the script's
    launches."""
    import tempfile

    t_phase = phase("phase 19: the USRBIO rings")
    info = {"shm": shm_fits("phase 19", clients=1, storage=len(SOCK_IDS),
                            extra_mib=RING_API_DEPTH)}
    log(f"  {shm_line()}; the rings need up to "
        f"{info['shm']['need_mib']} MiB")
    inputs = sock_inputs()
    uncounted, stall = collections.Counter(), {}
    ctl, sides, problems, legs, collector, api = None, {}, [], {}, None, None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            ctl = RingProcesses(Path(tmp), "cuda" if dev.type == "cuda"
                                else "cpu")
            log(f"  booted {len(ctl.procs)} processes in {ctl.boot_s:.1f} s")
            sides = {"ring": RingSide(ctl, dev, True),
                     "socket": RingSide(ctl, dev, False)}
            collector = RingCollector(ctl)
            sock_warm(ctl, dev)  # first installs, codecs, connections
            sides["ring"].connect()
            zero_counts()
            # the API first: its per-block length sync scans every chunk
            # of a target, so it runs before the other legs fill them
            t0 = time.perf_counter()
            legs["api"], api = ring_api(sides)
            ctl.snap_shm()  # the names each leg's rings had
            log(f"  api {time.perf_counter() - t0:.1f} s: "
                + json.dumps({k: v for k, v in legs["api"].items()
                              if k != "turns"}))
            t0 = time.perf_counter()
            legs["bench"] = ring_bench(sides)
            log(f"  bench {time.perf_counter() - t0:.1f} s: "
                + json.dumps({k: v for k, v in legs["bench"].items()
                              if k != "turns"}))
            t0 = time.perf_counter()
            legs["files"] = ring_files(ctl, sides, dev, inputs, uncounted,
                                       collector)
            ctl.snap_shm()
            log(f"  files {time.perf_counter() - t0:.1f} s: "
                + json.dumps({k: v for k, v in legs["files"].items()
                              if k != "turns"}))
            t0 = time.perf_counter()
            legs["recorders"] = ring_recorders(sides, inputs, collector)
            log(f"  recorders {time.perf_counter() - t0:.1f} s: "
                + json.dumps(legs["recorders"]))
            t0 = time.perf_counter()
            with one_rank_group(dev) as mesh:
                legs["loader"] = ring_loader(ctl, sides, dev, full, mesh,
                                             stall)
                ctl.snap_shm()
            log(f"  loader {time.perf_counter() - t0:.1f} s: "
                + json.dumps({k: v for k, v in legs["loader"].items()
                              if k != "turns"}))
            t0 = time.perf_counter()
            legs["api"]["degraded_seq_read_GiB_s"] = ring_api_degraded(
                ctl, sides, api)
            log(f"  api degraded {time.perf_counter() - t0:.1f} s: "
                + json.dumps(legs["api"]["degraded_seq_read_GiB_s"]))
            counts = read_counts()
            if dev.type == "cuda":
                info["on_card"] = sock_on_card(ctl.pid_of("storage"),
                                               ctl.device_files,
                                               device_work_nodes(ctl))
            info["calls"] = {n: {f"{t}:{m}": v for (t, m), v in
                                 sorted(s.calls().items())}
                             for n, s in sides.items()}
            info["storage_processes"] = collector.settled()
            info["boot_s"] = ctl.boot_s
        finally:
            if ctl is not None:
                ctl.snap_shm()
            if api is not None:
                ring_api_close(api)
            for side in sides.values():
                side.close()
            if collector is not None:
                collector.close()
            if ctl is not None:
                problems = ctl.close()
                # after a failure too: a SIGKILLed child's leftovers go
                info["shm_cleanup"] = ctl.shm.cleanup()
        require(not problems, f"phase 19: {problems}")
    held = info["shm_cleanup"]["still_held"]
    require(not held, f"phase 19: /dev/shm still holds {held} of its "
            "processes")
    counts = {n: c - uncounted[n] for n, c in counts.items()}
    require_main_path("the USRBIO rings", counts,
                      ("gf2_matmul", "crc32c_blocks"))
    log(json.dumps({"rings": legs, "info": info, "launches": counts,
                    "stall": {k: {a: getattr(v, a) for a in (
                        "count", "p50", "p99", "max")}
                        for k, v in stall.items()},
                    "card": card_line(),
                    "seconds": time.perf_counter() - t_phase}, default=str))
    log(f"rings: launches {counts} ({time.perf_counter() - t_phase:.1f} s)")
    return {n: counts[n] for n in counters()}


# -- phase 20 ----------------------------------------------------------------
# turns of each request on each client: 2, not phase 19's 3, for the
# script's 900 s (the whole run took 916.5 s with 3 here and phase 19's
# API at 3 turns of 256 MiB, on the C++ engine on a 9p disk)
NATIVE_TURNS = 2
NATIVE_DOWN_STRIPES = 4    # RS(12,4) stripes written while a node is down
NATIVE_DOWN_CR = 8         # 1 MiB CR chunks written while it is down
NATIVE_CHECK_BATCH = 32    # chunks a batch read of the engine-CRC check
NATIVE_PUSH_S = 0.25       # the storage processes' sample push period
NATIVE_NO_COMPACT_S = 3600  # the punch-hole compaction, parked: a restart
                            # replays the WAL of every chunk committed


class NativeProcesses(RingProcesses):
    """Phase 20: phase 17 (b)'s cluster on the native paths. Every child
    serves on ``--rpc native`` (the C++ transport); the storage processes
    run ``engine=native`` (the C++ engine, each on its own data dir under
    RUN_DIR), host no rings (``usrbio=0``: every call rides the C++
    transport), push their fast-path, resync and rebuild counters to a
    ``monitor_main`` every NATIVE_PUSH_S and never run the punch-hole
    compaction (NATIVE_NO_COMPACT_S), so that a killed process's WALs
    hold all it committed."""

    env = {"TPU3FS_USRBIO": "0"}
    rpc = "native"
    push_s = NATIVE_PUSH_S

    def _storage(self, node_id: int) -> None:
        self._start(f"storage{node_id}", "storage_main", node_id, [
            "--mgmtd=%s:%d" % self.maddr, "--heartbeat_interval", "0.5",
            "--config.engine=native",
            f"--config.data_dir={self.data_dir(node_id)}",
            "--config.usrbio=0", "--config.target_scan_interval_s=0.5",
            "--config.resync_interval_s=0.5",
            f"--config.punch_hole_interval_s={NATIVE_NO_COMPACT_S}",
            *self.push()])

    def target_dirs(self, node_id: int) -> list:
        """The node's target directories (``disk<i>/target<id>``)."""
        return sorted(self.data_dir(node_id).glob("disk*/target*"))


class NativeCollector(RingCollector):
    """The storage processes' C fast-path counters (``fastpath.*``: reads
    and head writes the C workers served, and their fallbacks), the CR
    resync's and the EC rebuild's moves, summed over the processes."""

    NAMES = ("fastpath.read_served", "fastpath.read_fallbacks",
             "fastpath.write_served", "fastpath.write_fallbacks",
             "storage.resync_chunks", "storage.resync_bytes",
             "ec.rebuild_shards", "ec.rebuild_bytes")
    PREFIXES = ("fastpath.", "storage.resync_", "ec.rebuild_")

    def settled(self) -> dict:
        """The totals once two reads agree: the first after a scan (the
        bridge publishes at each, 0.5 s) and a push, the next 0.5 s on."""
        deadline = time.monotonic() + 60.0
        time.sleep(0.5 + 2 * NATIVE_PUSH_S)
        prev = self.totals()
        while True:
            time.sleep(0.5)
            cur = self.totals()
            if cur == prev:
                return cur
            require(time.monotonic() < deadline,
                    "the collector's fast-path totals never settled")
            prev = cur


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


class NativeSide:
    """One of phase 20's two clients over the same processes, built by
    ``StubFactory``: ``"native"`` (the C++ client) or ``"tcp"`` (the
    Python one). Its storage client on ``dev``, a ``FileIoClient`` and a
    meta client share the factory's one RPC client; the messenger is
    built under ``TPU3FS_USRBIO=0``, so every call rides that client."""

    def __init__(self, ctl, dev, native: bool):
        from unittest import mock

        from tpu3fs_torch.client.file_io import FileIoClient
        from tpu3fs_torch.client.stubs import StubFactory
        from tpu3fs_torch.rpc.native_net import NativeRpcClient

        self.name = "native" if native else "python"
        self.stubs = StubFactory("native" if native else "tcp",
                                 mgmtd_addr=ctl.maddr,
                                 meta_addr=ctl.meta_addr)
        require(isinstance(self.stubs.rpc_client(), NativeRpcClient)
                == native, f"{self.name}: the stubs' client is "
                f"{type(self.stubs.rpc_client()).__name__}")
        with mock.patch.dict(os.environ, {"TPU3FS_USRBIO": "0"}):
            self.sc = self.stubs.storage_client(f"smoke-{self.name}",
                                                device=dev)
        self.fio = FileIoClient(self.sc)
        self.meta = self.stubs.meta_client()
        self.messenger = self.sc._messenger

    def calls(self) -> collections.Counter:
        return transport_calls(self.messenger)

    def close(self) -> None:
        self.fio.close()
        self.sc.close()
        self.stubs.close()


def native_turns(sides: dict, collector, fn) -> dict:
    """``fn(side, turn)`` on both clients, NATIVE_TURNS turns in rotated
    order; each turn's window of the storage processes' C counters rides
    in its row (``served``), and every call of either client rides the
    socket of its own RPC client. -> client name -> rows."""
    out = {"native": [], "python": []}
    before = collector.settled()
    for turn in range(NATIVE_TURNS):
        order = ("native", "python") if turn % 2 == 0 else ("python",
                                                            "native")
        for name in order:
            side = sides[name]
            calls = side.calls()
            row = fn(side, turn)
            require_transport(f"{name} client, turn {turn}", calls,
                              side.calls(), "socket")
            after = collector.settled()
            row["served"] = delta(after, before)
            before = after
            out[name].append(row)
    return out


def native_bench(sides: dict, collector) -> dict:
    """usrbio_bench's shape on the CR chain (ring_bench's requests) on the
    native and the Python client in turns; on every native turn the C
    workers served reads and head writes (a silent fallback to the
    Python dispatch fails here)."""
    from tpu3fs_torch.storage.craq import ReadReq
    from tpu3fs_torch.storage.types import ChunkId

    rng = np.random.default_rng(2020)
    data = [rng.integers(0, 256, MIB, dtype=np.uint8).tobytes()
            for _ in range(RING_CHUNKS)]
    gib = RING_CHUNKS * MIB / (1 << 30)

    def run(side, turn):
        fid = 20_000 + 10 * turn + (side.name == "python")
        sc, row = side.sc, {}
        t0 = time.perf_counter()
        got = sc.batch_write([(SOCK_CR_CHAIN, ChunkId(fid, i), 0, data[i])
                              for i in range(RING_CHUNKS)], chunk_size=MIB)
        row["batch_write_s"] = time.perf_counter() - t0
        require(all(r.ok for r in got), f"{side.name}: a batch write failed")
        t0 = time.perf_counter()
        got = sc.batch_read([ReadReq(SOCK_CR_CHAIN, ChunkId(fid, i), 0, -1)
                             for i in range(RING_CHUNKS)])
        row["batch_read_s"] = time.perf_counter() - t0
        require([bytes(r.data) for r in got] == data,
                f"{side.name}: the batch read's bytes differ")
        del got
        t0 = time.perf_counter()
        for i in range(RING_CHUNKS):
            require(sc.write_chunk(SOCK_CR_CHAIN, ChunkId(fid + 5, i), 0,
                                   data[i], chunk_size=MIB).ok,
                    f"{side.name}: a single write failed")
        row["write_op_ms"] = (time.perf_counter() - t0) * 1e3 / RING_CHUNKS
        t0 = time.perf_counter()
        for i in range(RING_CHUNKS):
            r = sc.read_chunk(SOCK_CR_CHAIN, ChunkId(fid + 5, i))
            require(r.ok and bytes(r.data) == data[i],
                    f"{side.name}: a single read's bytes differ")
        row["read_op_ms"] = (time.perf_counter() - t0) * 1e3 / RING_CHUNKS
        row["batch_write_GiB_s"] = gib / row["batch_write_s"]
        row["batch_read_GiB_s"] = gib / row["batch_read_s"]
        return row

    rows = native_turns(sides, collector, run)
    for i, row in enumerate(rows["native"]):
        require(row["served"]["fastpath.read_served"] > 0
                and row["served"]["fastpath.write_served"] > 0,
                f"native turn {i}: the C workers served "
                f"{row['served']}: a silent fallback to Python dispatch")
    ratio = {}
    for key in ("batch_write_GiB_s", "batch_read_GiB_s", "write_op_ms",
                "read_op_ms"):
        nat = med([r[key] for r in rows["native"]])
        py = med([r[key] for r in rows["python"]])
        ratio[key] = {"native": nat, "python": py,
                      "native_over_python": nat / py if py else None}
    return {"turns": rows, **ratio}


def dump_metas(messenger, routing, node_id: int) -> dict:
    """target id -> {chunk key: (committed ver, length, crc)} of every
    committed chunk the node's targets hold (``dump_chunkmeta``)."""
    out = {}
    for tid, info in routing.targets.items():
        if info.node_id != node_id or not info.chain_id:
            continue
        out[tid] = {m.chunk_id.to_bytes(): (m.committed_ver, m.length,
                                            m.checksum.value)
                    for m in messenger(node_id, "dump_chunkmeta", tid)
                    if m.committed_ver > 0}
    return out


def native_wal(ctl, node_id: int) -> dict:
    """The write-ahead logs the node's killed process left in its target
    dirs, by size only (opening a dir would replay and compact it)."""
    sizes = [(p / "wal.log").stat().st_size for p in ctl.target_dirs(node_id)
             if (p / "wal.log").exists()]
    return {"targets": len(ctl.target_dirs(node_id)), "wal_files": len(sizes),
            "wal_bytes": sum(sizes)}


def native_replayed(before: dict, after: dict) -> int:
    """Every chunk the node had committed before its SIGKILL (``before``)
    is in what its restarted process serves (``after``, both from
    ``dump_metas``) with its version, length and CRC. -> chunks kept."""
    for tid, metas in before.items():
        missing = {k for k in metas if after.get(tid, {}).get(k) != metas[k]}
        require(not missing, f"target {tid}: {len(missing)} of "
                f"{len(metas)} committed chunks lost or changed by the "
                "restarted process's replay")
    return sum(map(len, before.values()))


def native_files(ctl, sides: dict, dev, inputs: dict, collector) -> dict:
    """Phase 17's /a (48 RS(12,4) stripes) written and read by the native
    client; the first storage process SIGKILLed and /a read degraded (K1
    decodes of 4 lost shards a stripe here); NATIVE_DOWN_STRIPES stripes
    and NATIVE_DOWN_CR CR chunks written while it is down; its data dir
    left as the killed process left it (its WALs: NativeProcesses parks
    the punch-hole compaction, so they hold every chunk it committed) and
    a new process started on it: the time until its targets serve, what
    the resync moved, which must be exactly what was written while it
    was down, and every chunk it had committed before the SIGKILL served
    by the new process as it was (its replay); every file read back."""
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.storage.craq import ReadReq
    from tpu3fs_torch.storage.types import ChunkId

    side, out = sides["native"], {}
    body, mib = inputs["a"], len(inputs["a"]) / MIB
    down = np.random.default_rng(2021).integers(
        0, 256, (NATIVE_DOWN_STRIPES + NATIVE_DOWN_CR) * MIB,
        dtype=np.uint8).tobytes()
    w_body, cr = down[:NATIVE_DOWN_STRIPES * MIB], \
        down[NATIVE_DOWN_STRIPES * MIB:]

    def new_file(path, data):
        res = side.meta.create(path, flags=OpenFlags.WRITE | OpenFlags.CREATE,
                               client_id="smoke-native")
        t0 = time.perf_counter()
        side.fio.write(res.inode, 0, data)
        dt = time.perf_counter() - t0
        return side.meta.close(res.inode.id, res.session_id), dt

    def read(inode, data, what):
        t0 = time.perf_counter()
        require(side.fio.read(inode, 0, len(data)) == data,
                f"{what}: the bytes read differ")
        return time.perf_counter() - t0

    side.meta.mkdirs("/native", recursive=True)
    a, dt = new_file("/native/a", body)
    out["write_MiB_s"] = mib / dt
    out["read_MiB_s"] = mib / read(a, body, "/native/a")
    victim = SOCK_IDS[0]
    routing = ctl.admin.refresh_routing()
    before = dump_metas(side.messenger, routing, victim)
    ctl.fail(victim)
    out["degraded_MiB_s"] = mib / read(a, body, "/native/a degraded")
    w, _ = new_file("/native/w", w_body)
    got = side.sc.batch_write(
        [(SOCK_CR_CHAIN, ChunkId(21_000, i), 0, cr[i * MIB:(i + 1) * MIB])
         for i in range(NATIVE_DOWN_CR)], chunk_size=MIB)
    require(all(r.ok for r in got), "a CR write while the node is down "
            "failed")
    out["replay"] = native_wal(ctl, victim)
    require(out["replay"]["wal_bytes"] > 0, f"node {victim}'s killed "
            f"process left no WAL to replay: {out['replay']}")
    c0 = collector.settled()
    t0 = time.perf_counter()
    ctl.restart(victim, keep_data=True)
    out["registered_s"] = time.perf_counter() - t0
    sock_wait(lambda: sock_serving(ctl.admin.refresh_routing()),
              "the restarted node's targets to serve")
    sock_wait(lambda: sock_reads_served(
        side.messenger, ctl.admin.refresh_routing(), victim),
        f"node {victim} to serve reads of its targets")
    out["serving_s"] = time.perf_counter() - t0
    moved = delta(collector.settled(), c0)
    per_node = (K + M) // len(SOCK_IDS)  # shards of a stripe on one node
    out["moved"] = {k: moved[k] for k in (
        "ec.rebuild_shards", "ec.rebuild_bytes", "storage.resync_chunks",
        "storage.resync_bytes")}
    require(moved["ec.rebuild_shards"] == NATIVE_DOWN_STRIPES * per_node
            and moved["storage.resync_chunks"] == NATIVE_DOWN_CR
            and moved["storage.resync_bytes"] == NATIVE_DOWN_CR * MIB,
            f"the resync moved {out['moved']}, not just the "
            f"{NATIVE_DOWN_STRIPES} stripes and {NATIVE_DOWN_CR} CR "
            "chunks written while the node was down")
    out["read_after_restart_MiB_s"] = mib / read(a, body, "/native/a")
    read(w, w_body, "/native/w")
    got = side.sc.batch_read([ReadReq(SOCK_CR_CHAIN, ChunkId(21_000, i))
                              for i in range(NATIVE_DOWN_CR)])
    require(b"".join(bytes(r.data) for r in got) == cr,
            "the CR chunks written while the node was down differ")
    out["replay"]["chunks_kept"] = native_replayed(
        before, dump_metas(side.messenger, ctl.admin.refresh_routing(),
                           victim))
    return out


def native_engine_crcs(ctl, side, dev) -> dict:
    """Every chunk each storage process's engines hold, fetched by
    target-addressed batch reads (the C read path) with the CRC the
    engine reports, held against ``crc32c_many`` (K2 on the card) over
    the bytes. -> chunks and bytes checked."""
    from tpu3fs_torch.ops.crc32c import crc32c_many
    from tpu3fs_torch.storage.craq import ReadReq

    from tpu3fs_torch.storage.types import ChunkId

    routing = ctl.admin.refresh_routing()
    chunks = nbytes = 0
    for node_id in SOCK_IDS:
        metas = dump_metas(side.messenger, routing, node_id)
        for tid, keys in metas.items():
            chain = routing.targets[tid].chain_id
            ids = [ChunkId.from_bytes(k) for k in sorted(keys)]
            for i in range(0, len(ids), NATIVE_CHECK_BATCH):
                reqs = [ReadReq(chain, cid, target_id=tid)
                        for cid in ids[i:i + NATIVE_CHECK_BATCH]]
                replies = side.messenger(node_id, "batch_read", reqs)
                require(all(r.ok for r in replies),
                        f"target {tid}: a chunk read failed")
                bufs = [bytes(r.data) for r in replies]
                require(crc32c_many(bufs, device=dev)
                        == [r.checksum.value for r in replies],
                        f"target {tid}: an engine CRC differs from K2's")
                chunks += len(bufs)
                nbytes += sum(map(len, bufs))
    return {"chunks": chunks, "bytes": nbytes}


def native_read_paths(ctl) -> dict:
    """After the processes stopped: every target dir read here through
    the engine's batch reads with io_uring and with pread
    (``TPU3FS_NO_URING``), chunk for chunk equal. Where this machine
    refuses io_uring both would be pread: only the path is reported."""
    import hashlib
    from unittest import mock

    from tpu3fs_torch.storage.native_engine import (FS_TYPES,
                                                    NativeChunkEngine,
                                                    fs_type, read_path)

    def digests(path):
        e = NativeChunkEngine(str(path), device="cpu")
        try:
            metas = sorted(e.all_metadata(),
                           key=lambda m: m.chunk_id.to_bytes())
            cap = max([m.length for m in metas] + [1])
            out = []
            for i in range(0, len(metas), NATIVE_CHECK_BATCH):
                items = [(m.chunk_id, 0, -1)
                         for m in metas[i:i + NATIVE_CHECK_BATCH]]
                for code, data, ver, crc, aux in e.batch_read(items, cap):
                    out.append((int(code), hashlib.sha256(data).digest(),
                                ver, crc, aux))
            return out
        finally:
            e.close()

    root = ctl.data_root
    out = {"fs": FS_TYPES.get(fs_type(str(root)), hex(fs_type(str(root)))),
           "read_path": read_path(str(root))}
    if out["read_path"] != "io_uring":
        return {**out, "compared": False}
    t0 = time.perf_counter()
    paths = [p for n in SOCK_IDS for p in ctl.target_dirs(n)]
    chunks = 0
    for path in paths:
        with mock.patch.dict(os.environ, {"TPU3FS_NO_URING": "1"}):
            sync = digests(path)
        with mock.patch.dict(os.environ):
            os.environ.pop("TPU3FS_NO_URING", None)
            ring = digests(path)
        require(sync == ring, f"{path}: io_uring and pread reads differ")
        chunks += len(sync)
    return {**out, "compared": True, "targets": len(paths), "chunks": chunks,
            "s": time.perf_counter() - t0}


def native(dev, full=None, legs=("native",)) -> dict:
    """Phase 20: the native paths. Phase 17 (b)'s cluster with every
    service on the C++ transport and the storage processes on the C++
    engine on disk (NativeProcesses), driven by a StubFactory("native")
    client and a Python-transport one: usrbio_bench's shape in rotated
    turns (the C workers' reads and head writes counted each turn), /a
    with a SIGKILL, a degraded read, writes while down and a restart on
    the same data dir (the new process replays the killed one's WALs;
    the resync moves only what was written while down), every engine CRC
    against K2 on the card, and, where io_uring is allowed, the io_uring
    and pread read paths chunk for chunk equal. K1 and K2
    launch here as tensor-core kernels, no plain version. ``legs`` names
    what runs on the processes, in this order: "native" (phase 20's own
    requests), "operator" (phase 21) and "save" (phase 23 (c)); the last
    two need ``full`` (phase 13's data). -> leg -> its launches."""
    import tempfile

    t_phase = phase("phase 20: the native paths")
    inputs = sock_inputs()
    uncounted, info, steps = collections.Counter(), {}, {}
    ctl, sides, problems, collector = None, {}, [], None
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            ctl = NativeProcesses(Path(tmp), "cuda" if dev.type == "cuda"
                                  else "cpu")
            log(f"  booted {len(ctl.procs)} processes in {ctl.boot_s:.1f} s;"
                f" engines {ctl.engine_classes()}")
            collector = NativeCollector(ctl)
            sides = {"native": NativeSide(ctl, dev, True),
                     "python": NativeSide(ctl, dev, False)}
            sock_warm(ctl, dev)
            if "native" in legs:
                out["native"] = native_requests(ctl, sides, dev, inputs,
                                                collector, steps, info,
                                                uncounted)
            if "operator" in legs:
                out["operator"] = operator(ctl, sides, dev, inputs,
                                           collector, full)
            if "save" in legs:
                out["save"] = mesh_save(ctl, sides, dev, full)
            problems = ctl.close(keep_data=True)
            info["engines"] = ctl.engines
            require(not problems, f"phases 20, 21 and 23 (c): {problems}")
            t0 = time.perf_counter()
            steps["read_paths"] = native_read_paths(ctl)
            log(f"  read paths {time.perf_counter() - t0:.1f} s: "
                + json.dumps(steps["read_paths"]))
        finally:
            for side in sides.values():
                side.close()
            if collector is not None:
                collector.close()
            if ctl is not None:
                ctl.close()  # stops what still runs, removes the data dirs
                info["shm_cleanup"] = ctl.shm.cleanup()
    require(not ctl.data_root.exists(), f"phase 20: {ctl.data_root} is "
            "still there")
    held = info["shm_cleanup"]["still_held"]
    require(not held, f"phase 20: /dev/shm still holds {held}")
    if "native" not in out:
        return out
    counts = {n: c - uncounted[n] for n, c in out["native"].items()}
    require_main_path("the native paths", counts,
                      ("gf2_matmul", "crc32c_blocks"))
    log(json.dumps({"native": steps, "info": info, "launches": counts,
                    "card": card_line(),
                    "seconds": time.perf_counter() - t_phase}, default=str))
    log(f"native: launches {counts} ({time.perf_counter() - t_phase:.1f} s)")
    out["native"] = {n: counts[n] for n in counters()}
    return out


def native_requests(ctl, sides: dict, dev, inputs: dict, collector,
                    legs: dict, info: dict, uncounted) -> dict:
    """Phase 20's requests on its processes: the bench in turns, /a with
    the SIGKILL and the restart, the engine CRCs against K2, the on-card
    check. -> the script's launch counts (the checks' in ``uncounted``)."""
    zero_counts()
    t0 = time.perf_counter()
    legs["bench"] = native_bench(sides, collector)
    log(f"  bench {time.perf_counter() - t0:.1f} s: "
        + json.dumps({k: v for k, v in legs["bench"].items()
                      if k != "turns"}))
    t0 = time.perf_counter()
    legs["files"] = native_files(ctl, sides, dev, inputs, collector)
    log(f"  files {time.perf_counter() - t0:.1f} s: "
        + json.dumps(legs["files"]))
    c0 = read_counts()
    t0 = time.perf_counter()
    legs["engine_crcs"] = native_engine_crcs(ctl, sides["native"],
                                             dev)
    c1 = read_counts()
    uncounted.update({k: c1[k] - c0[k] for k in c1})
    log(f"  engine CRCs {time.perf_counter() - t0:.1f} s: "
        + json.dumps(legs["engine_crcs"]))
    counts = read_counts()
    if dev.type == "cuda":
        info["on_card"] = sock_on_card(ctl.pid_of("storage"),
                                       ctl.device_files,
                                       device_work_nodes(ctl))
    info["calls"] = {n: {f"{t}:{m}": v for (t, m), v in
                         sorted(s.calls().items())}
                     for n, s in sides.items()}
    info["storage_processes"] = collector.settled()
    info["boot_s"] = ctl.boot_s
    return counts


# -- phase 21 ----------------------------------------------------------------
# the operator's entry points on phase 20's processes: a FUSE mount
# (bin/fuse_main), the foreign-process loadgen through it, admin_cli over
# RpcFabricView, the GC and pack tools and the migration worker
OP_FUSE_NODE, OP_MIG_NODE, OP_NEW_NODE = 401, 402, 105
OP_PATCH = (MIB + 1000, MIB)   # the overwrite inside /a's second stripe
OP_TAIL = MIB                  # bytes written past /a's end, then cut off
# the loadgen at phase 19's API block and depth (1 MiB blocks, depth 32)
# on a 64 MiB file, one pass
OP_LOADGEN = ("64", "1024", "32", "1")
OP_PLACE = dict(nodes=180, group_size=3, targets_per_node=16, steps=200)
OP_PACK_FILES = 2              # of phase 13's 4 record files
OP_KV_PAGES = 32               # of phase 12's 2 MiB pages
OP_ATTN = ("q", "k", "v", "o")  # the layer's attention projections
OP_WAIT_S = 180.0              # the bound on a mount, a GC or a migration


def fuse_host() -> dict:
    """What the mount needs from the host: whether ``libfuse.so.2`` loads,
    where ``fusermount`` is, and the uid."""
    import ctypes
    import shutil

    try:
        ctypes.CDLL("libfuse.so.2")
        lib = "loads"
    except OSError as e:
        lib = f"does not load ({e})"
    return {"libfuse.so.2": lib, "fusermount": shutil.which("fusermount"),
            "uid": os.getuid()}


def mounted(path: Path) -> bool:
    with open("/proc/mounts") as f:
        return any(line.split()[1] == str(path) for line in f
                   if len(line.split()) > 1)


def op_env():
    """Sockets only for the clients a binary's ``main`` builds in this
    process (phase 20's processes host no rings; a messenger reads the
    switch when it is built)."""
    from unittest import mock

    return mock.patch.dict(os.environ, {"TPU3FS_USRBIO": "0"})


def op_main(module: str, args: list) -> str:
    """Run a binary's ``main`` (``tpu3fs_torch.<module>``) in this process
    on the card, its stdout captured; it must return 0."""
    import importlib
    import io

    main = importlib.import_module(f"tpu3fs_torch.{module}").main
    buf = io.StringIO()
    with op_env(), contextlib.redirect_stdout(buf):
        rc = main(args)
    require(rc == 0, f"{module} {args} returned {rc}: {buf.getvalue()}")
    return buf.getvalue()


def op_launches(ctl, node_id: int) -> dict:
    """The kernel launches a process pushed to the collector
    (``kernel.launches`` tagged with its node), once two reads
    ``ctl.push_s`` apart agree."""
    from tpu3fs_torch.monitor.collector import (COLLECTOR_SERVICE_ID,
                                                AggQueryReq, AggQueryRsp)
    from tpu3fs_torch.rpc.net import RpcClient

    cli = RpcClient()

    def read():
        rsp = cli.call(ctl.mon_addr, COLLECTOR_SERVICE_ID, 3,
                       AggQueryReq(name="kernel.launches",
                                   tags={"node": str(node_id)},
                                   window_s=3600.0), AggQueryRsp)
        got = collections.Counter()
        for row in rsp.rows:
            got[row.tags["kernel"]] += int(row.vsum)
        return {n: got[n] for n in counters()}

    try:
        prev, deadline = None, time.monotonic() + 60.0
        while True:
            time.sleep(2.5 * ctl.push_s)
            cur = read()
            if cur == prev:
                return cur
            require(time.monotonic() < deadline,
                    f"node {node_id}'s launch counts never settled")
            prev = cur
    finally:
        cli.close()


class OpMount:
    """``python -m tpu3fs_torch.bin.fuse_main --device cuda`` as a child of
    phase 20's cluster, mounted at RUN_DIR/mnt-<pid>; ``close`` SIGTERMs
    it, kills it on a timeout and detaches the mount in any case."""

    def __init__(self, ctl):
        self.ctl, self.child, self.refused = ctl, None, None
        self.mnt = RUN_DIR / f"mnt-{os.getpid()}"
        host = fuse_host()
        if host["libfuse.so.2"] != "loads":
            self.refused = f"libfuse.so.2 {host['libfuse.so.2']}"
            return
        self.mnt.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        ctl._start("fuse", "fuse_main", OP_FUSE_NODE, [
            "--mgmtd=%s:%d" % ctl.maddr, "--heartbeat_interval", "0.5",
            "--mountpoint", str(self.mnt), *ctl.push()])
        self.child = ctl.procs[-1]
        sock_wait(lambda: mounted(self.mnt)
                  or self.child.proc.poll() is not None,
                  "the FUSE process to mount", OP_WAIT_S)
        if self.child.proc.poll() is not None:
            text = self.child.log.read_text(errors="replace")
            # the host refuses the mount: mount(2) (as root) or fusermount
            # answered EPERM; anything else is a failure
            if "Operation not permitted" in text or "EPERM" in text:
                self.refused = "mount refused: EPERM: " + " ".join(
                    line for line in text.splitlines()
                    if "not permitted" in line)[:300]
                ctl.procs.remove(self.child)  # its exit is expected
                self.child = None
                return
            raise AssertionError(f"the FUSE process exited "
                                 f"{self.child.proc.returncode}:\n"
                                 + text[-3000:])
        self.mount_s = time.perf_counter() - t0

    def close(self) -> None:
        from tpu3fs_torch.fuse.mount import lazy_unmount

        import signal

        try:
            if self.child is not None and self.child.proc.poll() is None:
                self.child.proc.send_signal(signal.SIGTERM)
                try:
                    self.child.proc.wait(SOCK_CHILD_STOP_S)
                except subprocess.TimeoutExpired:
                    self.child.proc.kill()
                    self.child.proc.wait(SOCK_CHILD_STOP_S)
        finally:
            if self.mnt.exists():
                lazy_unmount(str(self.mnt))
                require(not mounted(self.mnt),
                        f"{self.mnt} is still mounted")
                self.mnt.rmdir()


class MountFiles:
    """Step 1's file calls through the kernel mount: plain ``open``,
    ``write``, ``read``, ``rename`` and ``truncate`` under the mount
    point, served by the FUSE process."""

    def __init__(self, mnt: Path):
        self.mnt = mnt

    def mkdir(self, path: str) -> None:
        os.mkdir(self.mnt / path.lstrip("/"))

    def write(self, path: str, off: int, data: bytes,
              create: bool = False) -> None:
        with open(self.mnt / path.lstrip("/"), "wb" if create else "r+b") \
                as f:
            f.seek(off)
            f.write(data)

    def read(self, path: str) -> bytes:
        with open(self.mnt / path.lstrip("/"), "rb") as f:
            return f.read()

    def rename(self, src: str, dst: str) -> None:
        os.rename(self.mnt / src.lstrip("/"), self.mnt / dst.lstrip("/"))

    def truncate(self, path: str, n: int) -> None:
        os.truncate(self.mnt / path.lstrip("/"), n)

    def size(self, path: str) -> int:
        return os.path.getsize(self.mnt / path.lstrip("/"))


class OpsFiles(MountFiles):
    """The same calls on ``fuse.ops.FuseOps`` in this process, in the
    pieces the kernel would send (128 KiB with ``big_writes``): the
    operation table without the kernel mount, for a host that refuses
    the mount."""

    PIECE = 128 << 10

    def __init__(self, side):
        from tpu3fs_torch.fuse.ops import FuseOps

        self.o = FuseOps(side.meta, side.fio)

    def mkdir(self, path: str) -> None:
        self.o.mkdir(path, 0o755)

    def write(self, path: str, off: int, data: bytes,
              create: bool = False) -> None:
        o = self.o
        fh = o.create(path, 0o644) if create else o.open(path, os.O_RDWR)
        try:
            for i in range(0, len(data), self.PIECE):
                o.write(fh, off + i, data[i:i + self.PIECE])
        finally:
            o.release(fh)

    def read(self, path: str) -> bytes:
        o = self.o
        fh = o.open(path, os.O_RDONLY)
        try:
            n = o.getattr(path).size
            return b"".join(o.read(fh, i, min(self.PIECE, n - i))
                            for i in range(0, n, self.PIECE))
        finally:
            o.release(fh)

    def rename(self, src: str, dst: str) -> None:
        self.o.rename(src, dst)

    def truncate(self, path: str, n: int) -> None:
        self.o.truncate(path, n)

    def size(self, path: str) -> int:
        return self.o.getattr(path).size


def op_files(ctl, fs, inputs: dict, messenger) -> tuple:
    """Step 1 with file calls (``fs``: through the kernel mount, or on the
    operation table where the host refuses the mount): phase 17 (b)'s /a
    written (as a part file with a tail, renamed, truncated to its
    length) and read back; 1 MiB overwritten inside a stripe (K1 at
    k = 1); the first storage node SIGKILLed and /a read degraded (K1
    decodes: 4 shards a stripe are lost), then a new process on its own
    data dir (the migration step reads /a again), until it serves reads
    of its targets over ``messenger``. Every byte equal to the source.
    -> the rates, and /a's expected bytes."""
    body = inputs["a"]
    off, n = OP_PATCH
    patch = np.random.default_rng(2121).integers(
        0, 256, n, dtype=np.uint8).tobytes()
    want = body[:off] + patch + body[off + n:]
    mib, out = len(body) / MIB, {}
    fs.mkdir("/op")
    t0 = time.perf_counter()
    fs.write("/op/a.part", 0, body + bytes(OP_TAIL), create=True)
    out["write_MiB_s"] = (mib + OP_TAIL / MIB) / (time.perf_counter() - t0)
    fs.rename("/op/a.part", "/op/a")
    fs.truncate("/op/a", len(body))
    require(fs.size("/op/a") == len(body), "/op/a's size after the "
            "truncate")
    t0 = time.perf_counter()
    require(fs.read("/op/a") == body, "/op/a read back differs")
    out["read_MiB_s"] = mib / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    fs.write("/op/a", off, patch)
    out["overwrite_ms"] = (time.perf_counter() - t0) * 1e3
    victim = SOCK_IDS[0]
    ctl.fail(victim)
    t0 = time.perf_counter()
    require(fs.read("/op/a") == want, "/op/a read degraded differs")
    out["degraded_MiB_s"] = mib / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ctl.restart(victim, keep_data=True)
    sock_wait(lambda: sock_serving(ctl.admin.refresh_routing()),
              "the restarted node's targets to serve")
    sock_wait(lambda: sock_reads_served(
        messenger, ctl.admin.refresh_routing(), victim),
        f"node {victim} to serve reads of its targets")
    out["restart_serving_s"] = time.perf_counter() - t0
    return out, want


def op_loadgen(mnt: OpMount) -> dict:
    """Step 2: ``hostsrc/usrbio_loadgen.cpp`` built by ``hostbuild`` and
    run as a foreign process through the mount (the ``3fs-virt`` symlink
    handshake): its read verified, no ring or fd left registered."""
    from tpu3fs_torch import hostbuild

    t0 = time.perf_counter()
    binary = hostbuild.executable("usrbio_loadgen")
    build_s = time.perf_counter() - t0
    run = subprocess.run([str(binary), str(mnt.mnt), *OP_LOADGEN],
                         capture_output=True, text=True, timeout=OP_WAIT_S)
    require(run.returncode == 0, f"usrbio_loadgen exited {run.returncode}:"
            f" {run.stdout} {run.stderr}")
    rows = {r["metric"]: r for r in map(json.loads,
                                        run.stdout.strip().splitlines())}
    require(rows["usrbio_loadgen_read"].get("verified") is True,
            f"the loadgen's read is not verified: {rows}")
    virt = mnt.mnt / "3fs-virt"
    left = {k: os.listdir(virt / k) for k in ("iors", "fds")}
    require(left == {"iors": [], "fds": []},
            f"registrations left in 3fs-virt: {left}")
    return {"build_s": build_s, "binary": binary.name,
            "write_GiB_s": rows["usrbio_loadgen_write"]["value"],
            "read_GiB_s": rows["usrbio_loadgen_read"]["value"],
            "shape": dict(zip(("file_mib", "block_kib", "depth", "iters"),
                              map(int, OP_LOADGEN)))}


def op_chunks(side, routing, file_ids) -> int:
    """Committed chunks of ``file_ids`` on every target of the cluster."""
    n = 0
    for tid, info in routing.targets.items():
        if not info.chain_id:
            continue
        n += sum(1 for m in side.messenger(info.node_id, "dump_chunkmeta",
                                           tid)
                 if m.chunk_id.file_id in file_ids)
    return n


def op_admin(ctl, side, dev, full: dict, not_counted) -> dict:
    """Step 3 from the binaries' own ``main``, in this process on the
    card: admin_cli's list-chains and ``verify-checksums --data`` on the
    EC chains (K2), place-CR-180 by ``solve-placement`` (K5) equal to
    ``entry.gen_chain_table``; dataload_pack_main over 2 of phase 13's
    record files and one loader batch equal to the records; the layer's
    attention block saved on the CR chain, archived to EC(12,4) by
    ckpt_gc_main and restored equal; 32 KV pages removed by
    kvcache_gc_main and their chunks dropped by meta's GC."""
    import tempfile

    from tpu3fs_torch import entry
    from tpu3fs_torch.ckpt import CheckpointManager
    from tpu3fs_torch.dataload import DataLoader, LoaderConfig, PackedDataset
    from tpu3fs_torch.kvcache.cache import KVCacheClient
    from tpu3fs_torch.meta.types import Layout

    connect = ["--device", dev.type, "--connect", "%s:%d" % ctl.maddr]
    out = {}
    t0 = time.perf_counter()
    chains = op_main("cli", [*connect, "list-chains"])
    require(all(str(c) in chains for c in (*SOCK_EC_CHAINS, SOCK_CR_CHAIN)),
            f"list-chains: {chains}")
    out["verify"] = {}
    for chain in SOCK_EC_CHAINS:
        got = op_main("cli", [*connect, "verify-checksums", "--data",
                              "--chain", str(chain)]).strip()
        m = re.fullmatch(r"read (\d+) chunks \((\d+) bytes\), 0 data "
                         r"mismatches", got)
        require(m, f"verify-checksums on chain {chain}: {got}")
        out["verify"][chain] = {"chunks": int(m.group(1)),
                                "bytes": int(m.group(2))}
    require(sum(v["chunks"] for v in out["verify"].values()) > 0,
            f"verify-checksums read no chunk: {out['verify']}")
    out["verify_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = OP_PLACE
    lines = op_main("cli", [
        *connect, "solve-placement", "--nodes", str(p["nodes"]),
        "--group-size", str(p["group_size"]), "--targets-per-node",
        str(p["targets_per_node"]), "--steps", str(p["steps"])]
    ).strip().splitlines()
    out["placement_s"] = time.perf_counter() - t0
    ref = not_counted(lambda: entry.gen_chain_table(
        p["nodes"], p["group_size"], p["targets_per_node"],
        steps=p["steps"], device=dev))
    require(lines == ref, "solve-placement's commands differ from "
            "entry.gen_chain_table's")
    out["placement_lines"] = len(lines)

    # dataload_pack_main: one sample file a record, from /dev/shm
    per = full["records"] // full["files"]
    records = full["host"][:per * OP_PACK_FILES]
    with tempfile.TemporaryDirectory(dir="/dev/shm") as tmp:
        for i, rec in enumerate(records):
            Path(tmp, f"{i:05d}.rec").write_bytes(rec)
        t0 = time.perf_counter()
        got = op_main("bin.dataload_pack_main", [
            *connect, "--out", "/op/tokens.rec", "--from-dir", tmp])
        out["pack_s"] = time.perf_counter() - t0
    require(got.startswith(f"packed {len(records)} records"),
            f"dataload_pack_main: {got}")

    def one_batch():
        ds = PackedDataset(side.meta, side.fio, ["/op/tokens.rec"])
        cfg = LoaderConfig(global_batch=full["batch"], seed=21,
                           dtype="<i4", sample_shape=(SEQ_TOKENS,),
                           depth=2, epochs=1)
        with DataLoader(ds, cfg) as ld:
            b = next(iter(ld))
        want = np.stack([np.frombuffer(records[i], "<i4") for i in b.ids])
        require(np.array_equal(np.asarray(b.data), want),
                "the packed file's batch differs from the records")
        return len(b.ids)

    out["batch_records"] = not_counted(one_batch)
    require_no_workers("phase 21's loader")

    # the attention block on the CR chain, then ckpt_gc_main's archive
    tree = {name: full["tree"][f"model.layers.0.self_attn.{name}_proj."
                               "weight"] for name in OP_ATTN}
    nbytes = sum(t.numel() * t.element_size() for t in tree.values())
    norms = {n: full["tree"][f"model.layers.0.{n}.weight"]
             for n in ("input_layernorm", "post_attention_layernorm")}
    mgr = CheckpointManager(side.meta, side.fio, root="/op-ckpt",
                            layout=Layout(table_id=2, chains=[SOCK_CR_CHAIN],
                                          chunk_size=MIB, seed=1))
    t0 = time.perf_counter()
    mgr.save(tree, 1)
    out["save_GiB_s"] = nbytes / (1 << 30) / (time.perf_counter() - t0)
    mgr.save(norms, 2)  # the newest step, which --archive-after 1 keeps
    t0 = time.perf_counter()
    got = op_main("bin.ckpt_gc_main", [
        *connect, "--root", "/op-ckpt", "--once", "--keep-last", "10",
        "--archive-after", "1", "--archive-ec-k", str(K),
        "--archive-ec-m", str(M), "--archive-chunk-size", str(MIB)])
    out["archive_s"] = time.perf_counter() - t0
    out["archive_GiB_s"] = nbytes / (1 << 30) / out["archive_s"]
    require("archived=1 steps_left=2" in got, f"ckpt_gc_main: {got}")
    for name in range(len(OP_ATTN)):
        ino = side.meta.stat(f"/op-ckpt/1/l{name}.s0")
        require(set(ino.layout.chains) <= set(SOCK_EC_CHAINS),
                f"step 1 leaf {name} is not on the EC chains: "
                f"{ino.layout.chains}")

    def restore():
        back = mgr.restore(1, like=tree)
        for name, want in tree.items():
            require(back[name].device == want.device
                    and torch.equal(back[name], want),
                    f"the archived {name}_proj differs after its restore")

    not_counted(restore)
    out["ckpt_MiB"] = nbytes / MIB

    # 32 KV pages, then kvcache_gc_main --ttl 0 and meta's GC
    pages, _ = kv_pages(dev)
    kv = KVCacheClient(side.meta, side.fio, root="/op-kv")
    for i in range(OP_KV_PAGES):
        kv.put(f"page{i}", pages[i].tobytes())
    ids = set()
    todo = ["/op-kv"]
    while todo:
        d = todo.pop()
        for e in side.meta.list_dir(d):
            if e.type.name == "DIRECTORY":
                todo.append(f"{d}/{e.name}")
            else:
                ids.add(e.inode_id)
    require(len(ids) == OP_KV_PAGES, f"{len(ids)} KV entries, not "
            f"{OP_KV_PAGES}")
    routing = ctl.admin.refresh_routing()
    before = op_chunks(side, routing, ids)
    t0 = time.perf_counter()
    got = op_main("bin.kvcache_gc_main", [
        *connect, "--root", "/op-kv", "--once", "--ttl", "0"])
    require(f"ttl_removed={OP_KV_PAGES}" in got, f"kvcache_gc_main: {got}")
    sock_wait(lambda: op_chunks(side, ctl.admin.refresh_routing(), ids)
              == 0, "meta's GC to drop the KV pages' chunks", OP_WAIT_S)
    out["kv_gc"] = {"entries": len(ids), "chunks_before": before,
                    "s": time.perf_counter() - t0}
    return out


def op_quorum(routing) -> list:
    """Chains below their quorum: a CR chain with fewer serving members
    than its three, an EC chain with fewer than k + m - 1 (one slot is
    rebuilt at a time)."""
    bad = []
    for chain in routing.chains.values():
        serving = sum(t.public_state.name == "SERVING" for t in chain.targets)
        need = chain.ec_k + chain.ec_m - 1 if chain.is_ec else 3
        if serving < need:
            bad.append((chain.chain_id, serving))
    return bad


def op_start_migration(ctl) -> None:
    """Step 4's processes, started at the phase's start so that they reach
    the card while steps 1-3 run: a fifth storage process on an empty
    engine (it holds no target until a move) and ``migration_main`` (its
    auto re-plan waits for an operator's job)."""
    ctl._storage(OP_NEW_NODE)
    ctl._start("migration", "migration_main", OP_MIG_NODE, [
        "--mgmtd=%s:%d" % ctl.maddr, "--heartbeat_interval", "0.5",
        "--config.poll_interval_s=0.2", *ctl.push()])


def op_migration(ctl, side, dev, collector, files: dict) -> dict:
    """Step 4: with ``op_start_migration``'s processes registered,
    ``admin_cli rebalance --apply`` plans the moves onto the fifth node
    and the worker runs them, the quorum checked all along; then every
    file reads back equal."""
    from tpu3fs_torch.migration import JobPhase

    connect = ["--device", dev.type, "--connect", "%s:%d" % ctl.maddr]
    ctl.registered(OP_NEW_NODE)
    ctl.registered(OP_MIG_NODE)
    c0 = collector.settled()
    t0 = time.perf_counter()
    plan = op_main("cli", [*connect, "rebalance", "--apply"])
    require("submitted jobs" in plan, f"rebalance --apply: {plan}")
    worst = []

    def settled():
        routing = ctl.admin.refresh_routing()
        worst.extend(op_quorum(routing))
        jobs = ctl.admin.migration_list()
        return jobs and all(not j.active for j in jobs) \
            and sock_serving(routing)

    deadline = time.monotonic() + OP_WAIT_S
    while not settled():
        require(time.monotonic() < deadline, "the migration jobs did not "
                f"settle: {op_main('cli', [*connect, 'migrate-status'])}")
        time.sleep(0.1)
    dt = time.perf_counter() - t0
    require(not worst, f"a chain fell below its quorum: {worst[:5]}")
    jobs = ctl.admin.migration_list()
    require(all(JobPhase(j.phase) == JobPhase.DONE for j in jobs),
            f"jobs not done: {[(j.job_id, j.phase) for j in jobs]}")
    routing = ctl.admin.refresh_routing()
    on_new = [tid for tid, t in routing.targets.items()
              if t.node_id == OP_NEW_NODE and t.chain_id]
    require(len(on_new) == len(jobs), f"node {OP_NEW_NODE} holds {on_new}"
            f" after {len(jobs)} moves")
    moved = delta(collector.settled(), c0)
    direct = sum(j.copied_chunks for j in jobs)
    copied = sum(j.copied_bytes for j in jobs)
    total = copied + moved["ec.rebuild_bytes"]
    for path, want in files.items():
        inode = side.meta.stat(path)
        require(side.fio.read(inode, 0, inode.length) == want,
                f"{path} differs after the migration")
    return {"jobs": [(j.job_id, j.chain_id, j.out_target, j.new_target,
                      j.dst_node, JobPhase(j.phase).name, j.copied_chunks,
                      j.copied_bytes) for j in jobs],
            "plan": plan.strip().splitlines(), "s": dt,
            "direct_copies": direct, "direct_bytes": copied,
            "decodes": moved["ec.rebuild_shards"],
            "decode_bytes": moved["ec.rebuild_bytes"],
            "bytes_moved": total, "MiB_s": total / MIB / dt,
            "status": op_main("cli", [*connect, "migrate-status"]).strip()}


def operator(ctl, sides: dict, dev, inputs: dict, collector,
             full: dict) -> dict:
    """Phase 21 on phase 20's processes (their turns done, before they
    stop): the mount and the loadgen, the admin CLI and the tools, the
    migration. The script's own launches (the tools' ``main`` in this
    process) are counted from 0 over the steps, the checks' launches
    taken out; the FUSE process's are read from its pushes to the
    collector. -> launches by kernel (the script's plus the FUSE
    process's)."""
    t_phase = phase("phase 21: the operator's entry points")
    log(f"  host for the mount: {json.dumps(fuse_host())}")
    side = sides["native"]
    uncounted, legs, info = collections.Counter(), {}, {}

    def not_counted(fn):
        c0 = read_counts()
        got = fn()
        c1 = read_counts()
        uncounted.update({k: c1[k] - c0[k] for k in c1})
        return got

    zero_counts()
    op_start_migration(ctl)
    mnt = OpMount(ctl)
    files = {}
    try:
        if mnt.refused:
            log(f"  mount and loadgen legs absent: the host refuses the "
                f"mount: {mnt.refused}")
            info["refused"] = mnt.refused
            t0 = time.perf_counter()
            legs["ops"], files["/op/a"] = op_files(
                ctl, OpsFiles(side), inputs, side.messenger)
            log(f"  no kernel mount: step 1 on the operation table in "
                f"this process {time.perf_counter() - t0:.1f} s: "
                + json.dumps(legs["ops"]))
        else:
            log(f"  mounted at {mnt.mnt} in {mnt.mount_s:.1f} s")
            t0 = time.perf_counter()
            legs["mount"], files["/op/a"] = op_files(
                ctl, MountFiles(mnt.mnt), inputs, side.messenger)
            log(f"  mount {time.perf_counter() - t0:.1f} s: "
                + json.dumps(legs["mount"]))
            t0 = time.perf_counter()
            legs["loadgen"] = op_loadgen(mnt)
            log(f"  loadgen {time.perf_counter() - t0:.1f} s: "
                + json.dumps(legs["loadgen"]))
        t0 = time.perf_counter()
        legs["admin"] = op_admin(ctl, side, dev, full, not_counted)
        log(f"  admin and tools {time.perf_counter() - t0:.1f} s: "
            + json.dumps(legs["admin"], default=str))
        packed = side.meta.stat("/op/tokens.rec")
        files["/op/tokens.rec"] = not_counted(
            lambda: side.fio.read(packed, 0, packed.length))
        t0 = time.perf_counter()
        legs["migration"] = not_counted(lambda: op_migration(
            ctl, side, dev, collector, files))
        log(f"  migration {time.perf_counter() - t0:.1f} s: "
            + json.dumps(legs["migration"], default=str))
        if not mnt.refused:
            info["fuse_launches"] = op_launches(ctl, OP_FUSE_NODE)
            if dev.type == "cuda":
                info["fuse_on_card"] = sock_on_card([mnt.child.proc.pid])
    finally:
        mnt.close()
    script = read_counts()
    if not mnt.refused:
        require(mnt.child.proc.returncode == 0, "the FUSE process exited "
                f"{mnt.child.proc.returncode} on SIGTERM")
    if not mnt.refused and dev.type == "cuda":
        fl = info["fuse_launches"]
        for name in ("gf2_matmul", "crc32c_blocks"):
            require(fl[name] > 0, f"the FUSE process launched no {name}")
        for name in ("gf2_matmul_plain", "crc32c_plain", "xor_reduce_plain",
                     "gf2_matmul_bitslice", "crc32c_blocks_table"):
            require(fl[name] == 0, f"the FUSE process ran {name}")
    counts = {n: script[n] - uncounted[n] for n in script}
    require_main_path("the operator's entry points", counts,
                      ("gf2_matmul", "crc32c_blocks", "swap_score",
                       "swap_apply"))
    launches = {n: counts[n] + info.get("fuse_launches", {}).get(n, 0)
                for n in counts}
    log(json.dumps({"operator": legs, "info": info, "launches": launches,
                    "script_launches": counts, "card": card_line(),
                    "seconds": time.perf_counter() - t_phase}, default=str))
    log(f"operator: launches {launches} "
        f"({time.perf_counter() - t_phase:.1f} s)")
    return launches


# -- phase 22 ----------------------------------------------------------------
# tests/test_chaos.py's SMALL spec: the clean search and the planted hunt
CHAOS_SMALL = dict(steps=20, events=6, storage_nodes=3, num_chains=2,
                   num_replicas=2)
CHAOS_CLEAN = (100, 3)         # (base seed, seeds): must stay green
CHAOS_HUNT = (0, 16)           # (base seed, seed budget): commit_skip found
CHAOS_KERNELS = ("gf2_matmul", "crc32c_blocks", "xor_reduce")
# corpus seeds whose oracle CRCs are held against crc32c_py, by workload
CHAOS_SAMPLE = ("commit_skip_chain_ack.json", "chain_parity_skip_hop.json",
                "peer_fill_stale_serve_through.json")
# scale_bench's bench_size at the thousand-node day (tests/test_scale.py)
SCALE_NODES, SCALE_DOMAINS = 1000, 10
# pollers of the cold routing fan-out in the whole script, cut from 1,000
# for its time limit (each cold poll serialises the whole snapshot on the
# host: 26-30 s for 1,000 on the card's host); --chaos polls all 1,000
SCALE_COLD_NODES = 100
SCALE_AB = (30, 3)             # the domain-blind A/B (scale_bench)
SCALE_REBALANCE_CHAINS = 10_000
SCALE_SLO_SERIES = 1000
SIMPLE_WAIT_S = 60.0           # the simple_example process's first reply


def chaos_launches(c0: dict, c1: dict) -> dict:
    """K1's, K2's and K3's launches between two reads of the counts."""
    return {n: c1[n] - c0[n] for n in CHAOS_KERNELS}


def chaos_row(label: str, report, secs: float, launches: dict) -> dict:
    """One run's line: wall seconds, events, checker statuses, launches."""
    row = {"run": label, "seconds": secs,
           "applied": report.events_applied,
           "skipped": report.events_skipped, "writes": report.writes,
           "acked": report.acked, "reads": report.reads,
           "statuses": {o.checker: o.status for o in report.outcomes},
           "violated": report.violated_checkers, "launches": launches}
    log(json.dumps({"chaos_run": row}))
    return row


def chaos_sample(dev, path: str) -> dict:
    """One corpus schedule through ``FabricRunner`` on ``dev`` (clean):
    every CRC its oracle took on the card is held against crc32c_py of the
    payload it stands for, the workload's and the serving sidecar's."""
    from tpu3fs_torch.chaos.schedule import Schedule
    from tpu3fs_torch.chaos.search import PAYLOAD_LEN, FabricRunner
    from tpu3fs_torch.ops.crc32c import crc32c_py

    with open(path) as f:
        sched = Schedule.from_json(json.dumps(json.load(f)["schedule"]))
    runner = FabricRunner(sched, device=dev)
    report = runner.run()
    require(not report.violated, f"{path} clean through FabricRunner: "
            + report.summary())
    want = {crc32c_py(f"w{t:06d}".encode().ljust(PAYLOAD_LEN, b"."))
            for t in range(1, runner.tag + 1)}
    sent = set().union(*runner.sent.values())
    require(sent == want, f"{path}: the oracle's CRCs on {dev} differ from "
            "crc32c_py")
    require(set().union(*runner.oracle.values()) - {None} <= want,
            f"{path}: an admissible CRC is no payload's")
    crcs = len(sent)
    if runner._serving is not None:
        for key, admissible, _ in runner._serving["reads"]:
            n = int(key.rsplit("-", 1)[1])  # the sidecar's round
            payload = f"kv{n:06d}".encode().ljust(64, b"#")
            require(admissible == {crc32c_py(payload)},
                    f"{path}: serving read {key}'s CRC differs from crc32c_py")
            crcs += 1
    return {"crcs": crcs, "writes": report.writes}


def chaos(dev) -> dict:
    """Phase 22 (a): the six corpus seeds through ``replay_seed`` on the
    card, clean (every checker green) and with the bug armed (the file's
    ``expect`` checkers violated); the clean search and the planted
    ``commit_skip`` hunt with its shrink; the oracle's CRCs of three
    seeds held against crc32c_py. -> launches by kernel."""
    from tpu3fs_torch.chaos import bugs
    from tpu3fs_torch.chaos.schedule import ScheduleSpec
    from tpu3fs_torch.chaos.search import (
        load_corpus,
        replay_seed,
        run_schedule,
        search_violations,
        shrink_schedule,
    )

    t_leg = time.perf_counter()
    rows = []

    def timed(fn):
        """-> (fn(), its wall seconds, its K1, K2 and K3 launches)."""
        c0, t0 = read_counts(), time.perf_counter()
        got = fn()
        secs, c1 = time.perf_counter() - t0, read_counts()
        return got, secs, chaos_launches(c0, c1)

    zero_counts()
    corpus = load_corpus()
    require(len(corpus) == 6, f"the corpus holds {len(corpus)} seeds, not 6")
    for path in corpus:
        name = os.path.basename(path)
        for with_bug in (False, True):
            (report, obj), secs, launches = timed(
                lambda: replay_seed(path, with_bug=with_bug, device=dev))
            label = f"{name} {'armed' if with_bug else 'clean'}"
            rows.append(chaos_row(label, report, secs, launches))
            if with_bug:
                require(set(obj["expect"]) <= set(report.violated_checkers),
                        f"{label}: {obj['bug']} not caught:\n"
                        + report.summary())
            else:
                require(not report.violated, f"{label} violates:\n"
                        + report.summary())
                statuses = rows[-1]["statuses"]
                for checker in obj["expect"]:
                    require(statuses[checker] == "passed",
                            f"{label}: {checker} {statuses[checker]}, not "
                            "passed (its sidecar did not run)")
    spec = ScheduleSpec(**CHAOS_SMALL)
    base, seeds = CHAOS_CLEAN
    (found, tried), secs, launches = timed(lambda: (
        search_violations(spec, base_seed=base, max_seeds=seeds,
                          device=dev)))
    require(found is None and tried == seeds,
            f"the clean search found a violation:\n"
            + (found.summary() if found else ""))
    rows.append({"run": f"search clean seeds {base}-{base + seeds - 1}",
                 "seconds": secs, "tried": tried, "launches": launches})
    log(json.dumps({"chaos_run": rows[-1]}))
    base, budget = CHAOS_HUNT
    bugs.arm("commit_skip")
    try:
        (found, tried), secs, launches = timed(lambda: (
            search_violations(spec, base_seed=base, max_seeds=budget,
                              device=dev)))
        require(found is not None, f"commit_skip not found in {budget} seeds")
        require({"replica_versions", "crc_oracle"}
                & set(found.violated_checkers),
                "the hunt's verdict names neither replica_versions nor "
                "crc_oracle:\n" + found.summary())
        rows.append(chaos_row(f"hunt commit_skip seed {found.schedule.seed} "
                              f"({tried} tried)", found, secs, launches))
        (shrunk, replays), secs, launches = timed(lambda: (
            shrink_schedule(found.schedule, device=dev)))
        again = run_schedule(shrunk, device=dev)
        require(again.violated, "the shrunk schedule no longer violates")
        if shrunk.events:
            require(not run_schedule(shrunk.prefix(len(shrunk.events) - 1),
                                     device=dev).violated,
                    "the shrunk schedule is not minimal")
    finally:
        bugs.disarm()
    fixed = run_schedule(shrunk, device=dev)
    require(not fixed.violated, "the shrunk schedule violates with "
            "commit_skip disarmed:\n" + fixed.summary())
    rows.append({"run": "shrink", "seconds": secs, "replays": replays,
                 "events": f"{len(found.schedule.events)} -> "
                           f"{len(shrunk.events)}", "launches": launches})
    log(json.dumps({"chaos_run": rows[-1]}))
    sample = {}
    for name in CHAOS_SAMPLE:
        path = next(p for p in corpus if os.path.basename(p) == name)
        sample[name] = chaos_sample(dev, path)
    counts = read_counts()
    require_main_path("the chaos search", counts,
                      ("gf2_matmul", "crc32c_blocks"))
    log(json.dumps({"chaos": {
        "runs": len(rows), "crc_sample": sample,
        "launches": {n: counts[n] for n in CHAOS_KERNELS},
        "seconds": time.perf_counter() - t_leg, "card": card_line()}}))
    return counts


def pct(sorted_vals: list, q: float) -> float:
    """scale_bench's percentile: the value at rank q of the sorted list."""
    return sorted_vals[min(int(q * len(sorted_vals)), len(sorted_vals) - 1)]


def scale(dev, cold_nodes: int) -> dict:
    """Phase 22 (b): the thousand-node day and scale_bench's bench_size on
    ``ScaleFabric(..., device=dev)``; the domain-blind A/B, the rebalance
    plan at 10,000 chains and the SLO aggregation; the cold routing
    fan-out polled by ``cold_nodes`` nodes (of a fabric that size). ->
    launches by kernel (the boot's placement: with solver_steps=0 none is
    required)."""
    from tpu3fs_torch.monitor.agg import WindowedAggregator
    from tpu3fs_torch.monitor.recorder import Sample
    from tpu3fs_torch.monitor.slo import SloEngine
    from tpu3fs_torch.placement.rebalance import TopologyDelta, plan_rebalance
    from tpu3fs_torch.scale import ScaleConfig, ScaleFabric

    t_leg = time.perf_counter()
    zero_counts()
    out = {}
    sf = ScaleFabric(ScaleConfig(num_nodes=SCALE_NODES,
                                 num_domains=SCALE_DOMAINS), device=dev)
    require(len(sf.chain_ids) == SCALE_NODES, "not one chain a node")
    require(sf.domain_violations() == [], "the aware table breaks domains")
    lat = sorted(sf.heartbeat_round())
    require(len(lat) == SCALE_NODES, "a node did not beat")
    out["boot_s"] = sf.boot_s
    out["heartbeat"] = {"round_s": sum(lat),
                        "mean_us": sum(lat) / len(lat) * 1e6,
                        "p99_us": pct(lat, 0.99) * 1e6}
    t0 = time.perf_counter()
    sf.tick()
    out["tick_sweep_s"] = time.perf_counter() - t0
    cold_sf = sf if cold_nodes == SCALE_NODES else ScaleFabric(
        ScaleConfig(num_nodes=cold_nodes, num_domains=SCALE_DOMAINS),
        device=dev)
    cold_b, cold_s = cold_sf.routing_fanout(up_to_date=False)
    warm_b, warm_s = sf.routing_fanout(up_to_date=True)
    require(warm_b * 10 * cold_nodes < cold_b * SCALE_NODES,
            "the warm fan-out is not the fast reply")
    out["fanout"] = {"cold_nodes": cold_nodes, "cold_bytes": cold_b,
                     "cold_s": cold_s, "warm_nodes": SCALE_NODES,
                     "warm_bytes": warm_b, "warm_s": warm_s}
    f1 = sf.kv_footprint()
    for _ in range(3):
        sf.heartbeat_round()
    f4 = sf.kv_footprint()
    require(f4["keys"] == f1["keys"]
            and f4["history"] <= f1["history"] * 1.5 + 64,
            f"the KV grows under heartbeats: {f1} -> {f4}")
    out["kv"] = {"after_1": f1, "after_4": f4}
    t0 = time.perf_counter()
    killed = sf.kill_domain("d0")
    kill_s = time.perf_counter() - t0
    q = sf.quorum_report()
    require(len(killed) == SCALE_NODES // SCALE_DOMAINS, "d0's size")
    require(q == {"ok": SCALE_NODES, "broken": 0},
            f"the whole-domain kill broke chains: {q}")
    sf.restart_domain("d0")
    require(sf.quorum_report()["broken"] == 0, "the restart broke chains")
    sf.complete_resync("d0")
    require(sf.quorum_report() == q, "the resync left chains short")
    out["domain_kill"] = {"killed": len(killed), "cycle_s": kill_s, **q}
    ab = {}
    for label, aware in (("aware", True), ("blind", False)):
        n, d = SCALE_AB
        small = ScaleFabric(ScaleConfig(num_nodes=n, num_domains=d,
                                        domain_aware=aware), device=dev)
        violations = len(small.domain_violations())
        small.kill_domain("d0")
        ab[label] = {"violations": violations, **small.quorum_report()}
    require(ab["aware"]["broken"] == 0 and ab["blind"]["broken"] > 0,
            f"the domain A/B: {ab}")
    out["domain_ab"] = ab
    big = ScaleFabric(ScaleConfig(
        num_nodes=SCALE_NODES, num_domains=SCALE_DOMAINS,
        targets_per_node=SCALE_REBALANCE_CHAINS * 3 // SCALE_NODES),
        device=dev)
    require(len(big.chain_ids) == SCALE_REBALANCE_CHAINS, "rebalance chains")
    routing = big.mgmtd.get_routing_info(-1)
    t0 = time.perf_counter()
    plan = plan_rebalance(routing, TopologyDelta(dead=[sorted(big.nodes)[0]]))
    out["rebalance"] = {"chains": len(big.chain_ids), "boot_s": big.boot_s,
                        "plan_s": time.perf_counter() - t0,
                        "moves": len(plan.moves),
                        "deferred": len(plan.deferred_chains),
                        "lambda_after": plan.after.lambda_max}
    require(plan.moves, "the rebalance plan moves nothing off the dead node")
    agg = WindowedAggregator(bucket_s=1.0, slots=60,
                             max_series=2 * SCALE_SLO_SERIES + 16)
    engine = SloEngine(agg)
    engine.configure("rule=hb_p99,metric=scale.hb,agg=p99,max=100")
    now = time.time()
    t0 = time.perf_counter()
    for w in range(5):
        agg.ingest([Sample(name="scale.hb", ts=now + w, tags={"node": str(i)},
                           count=8, min=1.0, max=20.0, mean=5.0, p50=4.0,
                           p90=9.0, p99=15.0)
                    for i in range(SCALE_SLO_SERIES)])
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verdicts = engine.evaluate(now + 5)
    out["slo"] = {"series": SCALE_SLO_SERIES, "windows": 5,
                  "ingest_s": ingest_s,
                  "evaluate_s": time.perf_counter() - t0,
                  "rules_ok": all(v.state != "firing"
                                  for v in verdicts.values())}
    require(out["slo"]["rules_ok"], "the SLO rule fires at p99 15 < 100")
    counts = read_counts()
    require_main_path("the scale fabric", counts, ())
    out["launches"] = {n: c for n, c in counts.items() if c}
    out["seconds"] = time.perf_counter() - t_leg
    log(json.dumps({"scale": out, "card": card_line()}))
    return counts


def simple_example(dev) -> dict:
    """Phase 22 (c): ``python -m tpu3fs_torch.simple_example.service
    --device <dev>`` answers a write and a read over the port's
    ``RpcClient`` and exits 0 on SIGTERM, its log free of tracebacks."""
    import signal
    import tempfile

    from tpu3fs_torch.rpc.net import RpcClient
    from tpu3fs_torch.simple_example.service import (
        SIMPLE_EXAMPLE_SERVICE_ID,
        SimpleReadReq,
        SimpleReadRsp,
        SimpleWriteReq,
        SimpleWriteRsp,
    )
    from tpu3fs_torch.utils.result import FsError

    t0 = time.perf_counter()
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        logf = Path(tmp) / "simple_example.log"
        with open(logf, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "tpu3fs_torch.simple_example.service",
                 "--port", str(port), "--device", dev.type],
                stdout=out, stderr=subprocess.STDOUT)
        rpc = RpcClient()
        try:
            addr = ("127.0.0.1", port)
            deadline = time.monotonic() + SIMPLE_WAIT_S
            while True:
                try:
                    wrote = rpc.call(addr, SIMPLE_EXAMPLE_SERVICE_ID, 1,
                                     SimpleWriteReq("smoke", "hello"),
                                     SimpleWriteRsp)
                    break
                except (FsError, OSError):
                    require(proc.poll() is None, "simple_example exited: "
                            + logf.read_text())
                    require(time.monotonic() < deadline, "simple_example "
                            f"gave no reply in {SIMPLE_WAIT_S} s")
                    time.sleep(0.1)
            first_s = time.perf_counter() - t0
            read = rpc.call(addr, SIMPLE_EXAMPLE_SERVICE_ID, 2,
                            SimpleReadReq("smoke"), SimpleReadRsp)
            require(wrote == SimpleWriteRsp(stored=1)
                    and read == SimpleReadRsp(True, "hello"),
                    f"simple_example replied {wrote}, {read}")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=SOCK_CHILD_STOP_S)
        finally:
            rpc.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait(SOCK_CHILD_STOP_S)
        text = logf.read_text()
    require(rc == 0, f"simple_example exited {rc} on SIGTERM")
    require("Traceback" not in text, text)
    got = {"first_reply_s": first_s, "exit": rc,
           "seconds": time.perf_counter() - t0}
    log(json.dumps({"simple_example": got}))
    return got


def chaos_scale(dev, cold_nodes: int = SCALE_COLD_NODES) -> tuple:
    """Phase 22: the chaos search, the scale fabric and simple_example.
    -> (the chaos leg's launches, the scale leg's)."""
    t0 = phase("phase 22: the chaos search, the scale fabric and "
               "simple_example")
    chaos_counts = chaos(dev)
    scale_counts = scale(dev, cold_nodes)
    simple_example(dev)
    zero = dict.fromkeys(CHAOS_KERNELS, 0)
    log(f"chaos and scale: launches {chaos_launches(zero, chaos_counts)} "
        f"and {chaos_launches(zero, scale_counts)} "
        f"({time.perf_counter() - t0:.1f} s, {card_line()})")
    return chaos_counts, scale_counts


# -- phase 23 ----------------------------------------------------------------
# (a) the ICI chain transport: phase 10's CR shape, chains of 3 on one node
MESH_CHAIN, MESH_ICI_CHUNKS, MESH_ICI_PATCHES = 3, 64, 32
MESH_ICI_PATCH = 4096          # bytes of a partial overwrite
MESH_ICI_FALLBACK_CHUNKS = 4   # the width-mismatched fabric's batch
# (b) the EC mesh rebuild: RS(12,4) at phase 11's shape, and RS(3,1)
MESH_EC = {"rs_12_4": (K, M, FAB_STRIPES), "rs_3_1": (3, 1, 16)}
# (c) the multi-rank save: phase 13's layer on 4 ranks, a (2, 2) mesh
MESH_RANKS, MESH_RANK_NODE0 = 4, 90   # rank r pushes as node 90 + r
MESH_SAVE_ROOT, MESH_WAIT_S = "/mesh-ckpt", 600.0


def mesh_ici_run(dev, transport: str, chain_len: int, chunks: np.ndarray,
                 patches: np.ndarray, counted: bool) -> dict:
    """One pass of (a) on a fresh in-process fabric (one storage node, 2
    CR chains of 3 on it): ``chunks`` written in one batch_write, then
    ``patches`` as partial overwrites in another; ``transport`` ici on a
    LocalMesh of ``chain_len`` positions, all on ``dev``. With
    ``counted`` the kernel counts are zeroed before the writes and read
    after. -> the replies, stored state, hits and fallbacks, write s."""
    from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
    from tpu3fs_torch.parallel import make_storage_mesh
    from tpu3fs_torch.storage.types import ChunkId

    mesh = (make_storage_mesh(chain_len, devices=[dev] * chain_len)
            if transport == "ici" else None)
    with deterministic(23):
        fab = Fabric(SystemSetupConfig(
            num_storage_nodes=1, num_chains=2, num_replicas=MESH_CHAIN,
            chunk_size=MIB, chain_transport=transport, mesh=mesh),
            device=dev)
    try:
        client = fab.storage_client()
        ops = [(fab.chain_ids[i % 2], ChunkId(23, i), 0, chunks[i].tobytes())
               for i in range(len(chunks))]
        over = [(fab.chain_ids[i % 2], ChunkId(23, i), 1000 + 7 * i,
                 patches[i].tobytes()) for i in range(len(patches))]
        if counted:
            zero_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        replies = client.batch_write(ops, chunk_size=MIB)
        write_s = time.perf_counter() - t0
        replies += client.batch_write(over, chunk_size=MIB)
        counts = read_counts() if counted else None
        require(all(r.ok for r in replies), f"{transport}: a write failed: "
                f"{[r for r in replies if not r.ok][:2]}")
        svc = next(iter(fab.nodes.values())).service
        ici = svc._ici
        return {"replies": [(r.code.name, r.update_ver, r.commit_ver,
                             r.checksum.value) for r in replies],
                "stored": fabric_stored(fab),
                "hits": ici.hits if ici else 0,
                "fallbacks": ici.fallbacks if ici else 0,
                "write_s": write_s, "counts": counts}
    finally:
        fab.close()


def mesh_ici(dev) -> dict:
    """Phase 23 (a): CR chains of 3 on an in-process fabric with the ICI
    transport on ``make_storage_mesh(3, devices=[dev] * 3)`` against the
    messenger: equal replies and committed state (bytes, versions, CRCs
    a target), hits on every batch, K4 (the hop cross-check) and K2 (the
    successors' installs) launched; a mesh whose chain axis (2) differs
    from the chains' width falls back on every batch with the messenger's
    state. Write MiB/s of both transports in turns (ici, messenger,
    messenger, ici) after a warm-up of each. -> the counted run's
    launches."""
    t0 = time.perf_counter()
    chunks = rand_u8((MESH_ICI_CHUNKS, MIB), 2301, dev).cpu().numpy()
    patches = rand_u8((MESH_ICI_PATCHES, MESH_ICI_PATCH), 2302,
                      dev).cpu().numpy()
    for transport in ("ici", "messenger"):  # warm-up: allocator, codecs
        mesh_ici_run(dev, transport, MESH_CHAIN, chunks[:4], patches[:2],
                     False)
    runs = {"ici": [], "messenger": []}
    for i, transport in enumerate(("ici", "messenger", "messenger", "ici")):
        runs[transport].append(mesh_ici_run(
            dev, transport, MESH_CHAIN, chunks, patches, counted=i == 0))
    ici, msg = runs["ici"][0], runs["messenger"][0]
    for name in ("replies", "stored"):
        for run in runs["ici"] + runs["messenger"]:
            require(run[name] == msg[name], f"phase 23 (a): the {name} of "
                    "the ICI and messenger fabrics differ")
    batches = 2 * 2  # two batch_writes over two chains
    require(ici["hits"] == batches and ici["fallbacks"] == 0,
            f"phase 23 (a): ICI hits {ici['hits']}, fallbacks "
            f"{ici['fallbacks']}, want {batches} and 0")
    counts = ici["counts"]
    require_main_path("the ICI chain transport", counts,
                      ("xor_fold_crc", "crc32c_blocks"))
    n = MESH_ICI_FALLBACK_CHUNKS
    narrow = mesh_ici_run(dev, "ici", 2, chunks[:n], patches[:n], False)
    wide = mesh_ici_run(dev, "messenger", MESH_CHAIN, chunks[:n],
                        patches[:n], False)
    require(narrow["hits"] == 0 and narrow["fallbacks"] > 0,
            f"phase 23 (a): a chain axis of 2 under chains of 3: hits "
            f"{narrow['hits']}, fallbacks {narrow['fallbacks']}")
    require(narrow["stored"] == wide["stored"]
            and narrow["replies"] == wide["replies"],
            "phase 23 (a): the fallen-back fabric's state differs")
    mib = MESH_ICI_CHUNKS
    out = {name: {"write_MiB_s": [mib / r["write_s"] for r in rs],
                  "write_MiB_s_median": med([mib / r["write_s"]
                                             for r in rs])}
           for name, rs in runs.items()}
    out.update(hits=ici["hits"], fallbacks_narrow=narrow["fallbacks"],
               seconds=time.perf_counter() - t0)
    log(json.dumps({"mesh_ici": out, "launches": counts,
                    "card": card_line()}))
    return counts


def mesh_rebuild_run(dev, k: int, m: int, stripes: int, mesh_on: bool
                     ) -> dict:
    """One pass of (b): an RS(k,m) fabric at phase 11's shape (4 nodes, 2
    chains, 1 MiB stripes), /a of ``stripes`` stripes written, the first
    node failed, its targets' engines emptied, the node back and
    ``resync_all`` (over a LocalMesh of k+m positions on ``dev`` with
    ``mesh_on``); kernel counts zeroed just before the resync and read
    just after. -> moved, seconds, lost bytes, launches, stored state,
    and whether every rebuilt chunk equals its original."""
    from tpu3fs_torch.fabric import Fabric, SystemSetupConfig
    from tpu3fs_torch.meta.store import OpenFlags
    from tpu3fs_torch.parallel import make_storage_mesh
    from tpu3fs_torch.storage.engine import MemChunkEngine

    body = rand_u8((stripes * MIB,), 2400 + k, dev).cpu().numpy().tobytes()
    mesh = (make_storage_mesh(k + m, devices=[dev] * (k + m))
            if mesh_on else None)
    with deterministic(24):
        fab = Fabric(SystemSetupConfig(
            num_storage_nodes=FAB_NODES, num_chains=FAB_CHAINS,
            chunk_size=MIB, ec_k=k, ec_m=m), device=dev)
        try:
            res = fab.meta.create("/a", flags=OpenFlags.WRITE
                                  | OpenFlags.CREATE, client_id="smoke")
            fab.file_client().write(res.inode, 0, body)
            fab.meta.close(res.inode.id, res.session_id)
            victim = sorted(fab.nodes)[0]
            targets = fab.nodes[victim].service.targets()
            original = {t.target_id: {
                m_.chunk_id.to_bytes(): t.engine.read(m_.chunk_id)
                for m_ in t.engine.all_metadata()} for t in targets}
            lost = sum(t.engine.used_size() for t in targets)
            fab.fail_node(victim)
            for t in targets:
                t.engine = MemChunkEngine(device=dev)
            fab.restart_node(victim)
            zero_counts()
            t0 = time.perf_counter()
            moved = fab.resync_all(rounds=6, mesh=mesh)
            secs = time.perf_counter() - t0
            counts = read_counts()
            rebuilt = {t.target_id: {
                m_.chunk_id.to_bytes(): t.engine.read(m_.chunk_id)
                for m_ in t.engine.all_metadata()} for t in targets}
            return {"moved": moved, "seconds": secs, "lost_bytes": lost,
                    "counts": counts, "stored": fabric_stored(fab),
                    "equal": rebuilt == original,
                    "chunks": sum(len(v) for v in original.values())}
        finally:
            fab.close()


def mesh_rebuild(dev) -> dict:
    """Phase 23 (b): the EC mesh rebuild (``resync_all(mesh=...)``) at
    RS(12,4) and RS(3,1), each against the resync without a mesh on the
    same writes: every rebuilt chunk equal to its original, the stored
    state equal to the meshless resync's; K1 launched at RS(12,4) (every
    shard outside the k survivors declared lost: 4 decoded), K3 at
    RS(3,1). Rebuild MiB/s of both routes, mesh first. -> the mesh runs'
    launches, summed."""
    t0 = time.perf_counter()
    total, out = collections.Counter(), {}
    for name, (k, m, stripes) in MESH_EC.items():
        mesh_rebuild_run(dev, k, m, 2, True)  # warm-up: codecs, matrices
        runs = {"mesh": mesh_rebuild_run(dev, k, m, stripes, True),
                "no_mesh": mesh_rebuild_run(dev, k, m, stripes, False)}
        for route, run in runs.items():
            require(run["equal"] and run["moved"] >= run["chunks"] > 0,
                    f"phase 23 (b) {name} {route}: rebuilt chunks differ "
                    f"or missing (moved {run['moved']} of {run['chunks']})")
        require(runs["mesh"]["stored"] == runs["no_mesh"]["stored"],
                f"phase 23 (b) {name}: the mesh and meshless rebuilds' "
                "stored state differ")
        need = ("gf2_matmul",) if m > 1 else ("xor_reduce",)
        require_main_path(f"the EC mesh rebuild {name}",
                          runs["mesh"]["counts"], need)
        total.update(runs["mesh"]["counts"])
        out[name] = {route: {
            "moved": r["moved"], "seconds": r["seconds"],
            "rebuild_MiB_s": r["lost_bytes"] / MIB / r["seconds"],
            "launches": {n: c for n, c in r["counts"].items() if c}}
            for route, r in runs.items()}
    out["seconds"] = time.perf_counter() - t0
    log(json.dumps({"mesh_rebuild": out, "card": card_line()}))
    return {n: total[n] for n in counters()}


def mesh(dev) -> tuple:
    """Phase 23 (a) and (b); (c) runs on phase 20's processes
    (``mesh_save``). -> ((a)'s launches, (b)'s)."""
    t0 = phase("phase 23: the ICI chain transport and the EC mesh rebuild")
    ici = mesh_ici(dev)
    rebuild = mesh_rebuild(dev)
    log(f"mesh: ICI launches {dict((n, c) for n, c in ici.items() if c)}, "
        f"rebuild {dict((n, c) for n, c in rebuild.items() if c)} "
        f"({time.perf_counter() - t0:.1f} s, {card_line()})")
    return ici, rebuild


def mesh_placements(shape: tuple) -> list:
    """(c)'s sharding on the (dp, chain) mesh: a matrix's rows over dp and
    columns over chain, a vector over dp and replicated over chain."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0), Shard(1)] if len(shape) == 2 else [Shard(0),
                                                          Replicate()]


def mesh_save_rank(rank: int, world: int, port: int, mgmtd, meta, mon,
                   out: str, device: str, leaves: dict) -> None:
    """One rank process of (c): a gloo group over ``world`` ranks,
    ``leaves`` (name -> shape) drawn on ``device`` as ``train_data``
    draws them, this rank's boxes as DTensors on a (2, 2) mesh of
    ``device`` (cuda DTensors on the card), one
    ``CheckpointManager.save`` through a C++-transport client of phase
    20's processes; its kernel launches pushed to the collector as
    ``kernel.launches`` tagged node 90 + rank; a line of JSON to
    ``out``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from unittest import mock

    from tpu3fs_torch import kernels
    from tpu3fs_torch.ckpt import CheckpointManager
    from tpu3fs_torch.ckpt.manifest import placement_box
    from tpu3fs_torch.client.file_io import FileIoClient
    from tpu3fs_torch.client.stubs import StubFactory
    from tpu3fs_torch.monitor.collector import BufferedCollectorSink
    from tpu3fs_torch.monitor.recorder import Monitor

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=MESH_WAIT_S))
    stubs = None
    try:
        recorder = kernels.launch_recorder({"node": str(MESH_RANK_NODE0
                                                        + rank)})
        sink = BufferedCollectorSink(tuple(mon))
        Monitor.default().add_sink(sink)
        grid = init_device_mesh(dev.type, (world // 2, 2),
                                mesh_dim_names=("dp", "chain"))
        coord, sizes = grid.get_coordinate(), tuple(grid.shape)
        full = train_data(dev, {"leaves": leaves, "records": 0})["tree"]
        tree = {}
        for key, value in full.items():
            pl = mesh_placements(tuple(value.shape))
            off, shape = placement_box(tuple(value.shape), pl, sizes, coord)
            local = value[tuple(slice(o, o + n)
                                for o, n in zip(off, shape))].clone()
            tree[key] = DTensor.from_local(local, grid, pl, run_check=False,
                                           shape=value.shape,
                                           stride=value.stride())
        del full
        stubs = StubFactory("native", mgmtd_addr=tuple(mgmtd),
                            meta_addr=tuple(meta))
        with mock.patch.dict(os.environ, {"TPU3FS_USRBIO": "0"}):
            sc = stubs.storage_client(f"mesh-rank{rank}", device=dev)
        mgr = CheckpointManager(stubs.meta_client(), FileIoClient(sc),
                                root=MESH_SAVE_ROOT,
                                client_id=f"mesh-rank{rank}")
        dist.barrier()
        t0 = time.perf_counter()
        manifest = mgr.save(tree, 1)
        secs = time.perf_counter() - t0
        launches = kernels.counts()
        Monitor.default().collect()  # the launches, to the collector
        require(sink.backlog() == 0, f"rank {rank}: the push failed")
        mine = sum(int(t.to_local().numel()) * 4 for t in tree.values())
        Path(out).write_text(json.dumps({
            "rank": rank, "seconds": secs, "local_bytes": mine,
            "shards": len(manifest.shards),
            "crcs": [s.crc for s in manifest.shards],
            "launches": {n: c for n, c in launches.items() if c},
            "recorder": type(recorder).__name__}))
        sc.close()
    finally:
        if stubs is not None:
            stubs.close()
        dist.destroy_process_group()


def mesh_save(ctl, sides: dict, dev, full: dict) -> dict:
    """Phase 23 (c) on phase 20's processes: MESH_RANKS rank processes on
    a gloo group save phase 13's Llama-3.1-8B decoder layer as DTensors
    sharded over a (2, 2) mesh (``mesh_save_rank``); rank 0 commits. The
    manifest is held against the layout (4 boxes a matrix, 2 a norm, the
    mesh), every rank's CRCs against the committed ones, and a verified
    restore through the script's native client against ``full``'s
    leaves byte for byte. -> the ranks' launches as they pushed them to
    the collector (the script's restore is a check, not counted)."""
    t_phase = phase("phase 23 (c): the multi-rank save")
    from tpu3fs_torch.ckpt import CheckpointManager

    port, procs, outs = free_port(), [], []
    code = ("import sys, json; sys.path.insert(0, {root!r}); "
            "import chip_smoke as cs; cs.mesh_save_rank(*json.loads("
            "sys.argv[1]))")
    root = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    try:
        for r in range(MESH_RANKS):
            outs.append(ctl.logdir / f"mesh-rank{r}.json")
            log_path = ctl.logdir / f"mesh-rank{r}.log"
            with open(log_path, "w") as logf:
                procs.append((subprocess.Popen(
                    [sys.executable, "-c", code.format(root=root),
                     json.dumps([r, MESH_RANKS, port, ctl.maddr,
                                 ctl.meta_addr, ctl.mon_addr,
                                 str(outs[-1]), dev.type,
                                 full["leaves"]])],
                    stdout=logf, stderr=subprocess.STDOUT, cwd=root,
                    env={**os.environ, "TPU3FS_USRBIO": "0"}), log_path))
        deadline = time.monotonic() + MESH_WAIT_S
        for proc, _ in procs:
            try:
                proc.wait(max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(SOCK_CHILD_STOP_S)
    wall = time.perf_counter() - t0
    for (proc, log_path), r in zip(procs, range(MESH_RANKS)):
        require(proc.returncode == 0, f"mesh rank {r} exited "
                f"{proc.returncode}:\n"
                + log_path.read_text(errors="replace")[-3000:])
    ranks = [json.loads(p.read_text()) for p in outs]
    side = sides["native"]
    mgr = CheckpointManager(side.meta, side.fio, root=MESH_SAVE_ROOT)
    c0 = read_counts()
    manifest = mgr.manifest(1)
    crcs = [s.crc for s in manifest.shards]
    for row in ranks:
        require(row["crcs"] == crcs, f"rank {row['rank']}'s CRCs differ "
                "from the committed manifest's")
    per_leaf = {leaf.key: len(manifest.shards_of_leaf(i))
                for i, leaf in enumerate(manifest.leaves)}
    require(all(n == (4 if len(full["tree"][k].shape) == 2 else 2)
                for k, n in per_leaf.items())
            and manifest.mesh == {"dp": 2, "chain": 2},
            f"the manifest's boxes {per_leaf}, mesh {manifest.mesh}")
    t1 = time.perf_counter()
    back = mgr.restore(1, like=full["tree"])
    restore_s = time.perf_counter() - t1
    for key, want in full["tree"].items():
        require(back[key].device == want.device
                and torch.equal(back[key], want),
                f"phase 23 (c): {key} differs after its restore")
    uncounted = {n: c - c0[n] for n, c in read_counts().items()}
    del back
    pushed = collections.Counter()
    for r in range(MESH_RANKS):
        pushed.update(op_launches(ctl, MESH_RANK_NODE0 + r))
    reported = collections.Counter()
    for row in ranks:
        reported.update(row["launches"])
    require(all(pushed[n] == reported[n] for n in counters()),
            f"the ranks pushed {dict(pushed)}, reported {dict(reported)}")
    launches = {n: pushed[n] for n in counters()}
    require_main_path("the multi-rank save", launches, ("crc32c_blocks",))
    nbytes = sum(t.numel() * t.element_size() for t in full["tree"].values())
    slowest = max(row["seconds"] for row in ranks)
    info = {"ranks": MESH_RANKS, "leaves": len(per_leaf),
            "shards": len(crcs), "MiB": nbytes / MIB,
            "save_s_by_rank": [row["seconds"] for row in ranks],
            "save_GiB_s": nbytes / (1 << 30) / slowest,
            "restore_s": restore_s,
            "restore_GiB_s": nbytes / (1 << 30) / restore_s,
            "ranks_wall_s": wall, "restore_launches_uncounted":
            {n: c for n, c in uncounted.items() if c},
            "leaves_on": f"{dev.type} DTensors on a (2, 2) {dev.type} "
                         "mesh over gloo"}
    log(json.dumps({"mesh_save": info, "launches": launches,
                    "card": card_line(),
                    "seconds": time.perf_counter() - t_phase}))
    log(f"mesh save: launches {dict((n, c) for n, c in launches.items() if c)}"
        f" ({time.perf_counter() - t_phase:.1f} s)")
    return launches


def main() -> int:
    t0 = time.perf_counter()
    kind = environment()
    import tpu3fs_torch  # noqa: F401  (fails when run outside the repo)

    log(shm_line())
    log(host_line())
    dev = torch.device("cuda")
    build()
    if sys.argv[1:] == ["--fold-variants"]:
        found = fold_variants(dev)
        out = OUT_DIR / "fold_variants.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(found, indent=1))
        for shape, row in found.items():
            log(f"{shape}: bound {row.pop('bound_ms')} ms")
            for name, got in row.items():
                log(f"  {name:<22} {got['plan']} new "
                    f"{got['graph_turns_ms']['new']} old "
                    f"{got['graph_turns_ms']['old']} ms (graph)")
        return 0
    if sys.argv[1:] == ["--kvcache"]:
        _, kv_card, kv_data = kvcache(dev)
        kv_shares(dev, kv_card, kv_data)
        return 0
    if sys.argv[1:] == ["--ckpt"]:
        _, train_card, train_full = train(dev)
        train_shares(dev, train_card, train_full)
        return 0
    if sys.argv[1:] == ["--fetch"]:
        full = train_data(dev, TRAIN_FULL)
        _, fetch_card = fetch(dev, full)
        fetch_shares(dev, fetch_card, full)
        return 0
    if sys.argv[1:] == ["--sockets"]:
        sockets(dev, train_data(dev, TRAIN_FULL))
        return 0
    if sys.argv[1:] == ["--fleet"]:
        fleet(dev)
        return 0
    if sys.argv[1:] == ["--rings"]:
        rings(dev, train_data(dev, TRAIN_FULL))
        return 0
    if sys.argv[1:] == ["--native"]:
        native(dev)
        return 0
    if sys.argv[1:] == ["--operator"]:
        native(dev, train_data(dev, TRAIN_FULL), legs=("operator",))
        return 0
    if sys.argv[1:] == ["--chaos"]:
        chaos_scale(dev, cold_nodes=SCALE_NODES)
        return 0
    if sys.argv[1:] == ["--mesh"]:
        mesh(dev)
        native(dev, train_data(dev, TRAIN_FULL), legs=("save",))
        log(f"total {time.perf_counter() - t0:.1f} s")
        return 0
    cmps = {name: Compare() for name in ("K1", "K2", "K3", "K4", "K5",
                                         "K5s", "K5a")}
    check_k1(dev, cmps["K1"])
    check_k2(dev, cmps["K2"])
    check_k3(dev, cmps["K3"])
    check_k4(dev, cmps["K4"])
    check_k5(dev, cmps["K5"])
    check_k5_swap(dev, cmps["K5s"], cmps["K5a"])
    paths = {"stripe_server": serve(dev)}
    paths["hops"] = hops(dev, Compare())
    paths["multi_device"] = multi_device(dev)
    paths["storage"], inputs, card = storage(dev)
    paths["serving"], served = serving(dev)
    paths["kvcache"], kv_card, kv_data = kvcache(dev)
    paths["train"], train_card, train_full = train(dev)
    paths["placement"] = placement(dev, Compare())
    kernels = times(dev, paths, cmps)
    # after phase 15: with phase 16 run just before it, K4's graph trace
    # once lost one of its 30 kernel records
    paths["fetch"], fetch_card = fetch(dev, train_full)
    paths["sockets"] = sockets(dev, train_full)
    paths["fleet"] = fleet(dev)
    paths["rings"] = rings(dev, train_full)
    on_native = native(dev, train_full,
                       legs=("native", "operator", "save"))
    paths["native"], paths["operator"], paths["mesh_save"] = (
        on_native["native"], on_native["operator"], on_native["save"])
    paths["chaos"], paths["scale"] = chaos_scale(dev)
    paths["ici"], paths["mesh_rebuild"] = mesh(dev)
    for row in kernels:
        for path in ("fetch", "sockets", "fleet", "rings", "native",
                     "operator", "mesh_save", "chaos", "scale", "ici",
                     "mesh_rebuild"):
            row["launches_by_path"][path] = paths[path][row["name"]]
        row["launches"] = sum(row["launches_by_path"].values())
    storage_shares(dev, inputs, card)
    serving_shares(dev, served)
    kv_shares(dev, kv_card, kv_data)
    train_shares(dev, train_card, train_full)
    fetch_shares(dev, fetch_card, train_full)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
