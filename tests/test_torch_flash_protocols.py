"""The synchronisation protocols of the flash kernels above head_dim 128,
modelled in Python and run under random interleavings of their warps.

No card and no nvcc here, so what a hang would cost on the card is
rehearsed on the CPU: each warp of a block is a list of the operations
the kernel source issues in order (waits on a TMA stage, releases of a
stage, arrivals at and waits on named barriers), and a scheduler runs
them in random order, landing the TMA loads at random later moments.
The model holds the hardware's rules:

  - a TMA stage's full mbarrier is waited by parity: ``try_wait.parity``
    passes when the stage's completed phases differ in parity from the
    one asked for, so a warp that skips a phase may pass on the wrong
    one; every pass must find the stage holding the load asked for;
  - csrc/flash_wide_wgmma.cuh's ring refills a stage with load L + ns
    once all 8 warps released load L (the last releaser issues it);
  - a named barrier completes a generation when its thread count has
    arrived (``bar.arrive`` adds and goes on, ``bar.sync`` adds and
    waits); every arrival in one generation must belong to the same
    step of the kernel, or one warp has paired with the wrong step.

Cases: the bf16 wgmma forward, dK/dV and dQ (``wgmma_wide_fwd_kernel``,
``wgmma_wide_dkdv_kernel``, ``wgmma_wide_dq_kernel``) at their
launchers' stage counts, and the float32 forward on ``mma.sync``
(``csrc/flash_fwd_wide_mma.cuh``: two groups of 4 warps, their own
rings, pair barriers); each completes under every interleaving tried.
Below the stage counts the launchers check (``launch_wide_dkdv``: a
slice's units; ``launch_wide_dq``: a tile's product pairs) the model
deadlocks, and a variant the float32 forward avoids is caught: a
hand-off that reuses a pair barrier once more at the end.
"""
import random

import pytest

# csrc/flash_wgmma.cuh and csrc/flash_wide_wgmma.cuh
BOX = 64 * 64 * 2
BLOCK_SMEM = 232448
MAX_STAGES = 8
P_BYTES = 64 * 64 * 4
WARPS = 8


def _stages(smem):
    """stages_within: the most stages (<= MAX_STAGES) whose smem fits."""
    ns = 0
    while ns < MAX_STAGES and smem(ns + 1) <= BLOCK_SMEM:
        ns += 1
    return ns


def _plan(d):
    """plan_of: (units, slices, units a slice)."""
    nq = -(-d // 64)
    nz = -(-d // 256)
    return nq, nz, -(-nq // nz)


def fwd_smem(nq, ns):
    return 1024 + 2 * nq * BOX + ns * 2 * BOX + (1 + ns) * 8 + ns * 4


def dkdv_smem(nq, ns):  # also dQ's: Q and dO resident in K's and V's place
    return 1024 + 2 * nq * BOX + ns * 2 * BOX + P_BYTES + (1 + ns) * 8 + \
        ns * 4


# --- the bf16 wgmma kernels' programs ------------------------------------

def wgmma_fwd(d, n_tiles, z):
    """wgmma_wide_fwd_kernel: ({warp: ops}, ns, total loads)."""
    nq, _, per = _plan(d)
    nv = min(per, nq - z * per)
    ops = []
    L = 0
    for _ in range(n_tiles):
        for j in range(nq):
            ops.append(("wait", L))
            if j > 0:
                ops.append(("release", L - 1))
            L += 1
        ops.append(("release", L - 1))
        ops += [("wait", L + u) for u in range(nv)]
        ops += [("release", L + u) for u in range(nv)]
        L += nv
    ns = _stages(lambda s: fwd_smem(nq, s))
    return {w: list(ops) for w in range(WARPS)}, ns, L


def wgmma_dkdv(d, n_tiles, z, ns=None):
    """wgmma_wide_dkdv_kernel: warpgroup 0 (warps 0-3) S^T, P^T, dV;
    warpgroup 1 dP^T, dS^T, dK; P^T handed over behind PFull/PEmpty.
    Where the slice's units are the tile's last score units (`held`) the
    stages are kept through the products."""
    nq, _, per = _plan(d)
    v0 = z * per
    nv = min(per, nq - v0)
    held = v0 + nv == nq
    nl = nq + (0 if held else nv)

    def kept(j):
        return held and j >= nq - nv

    def product(u):
        return nq - nv + u if held else nq + u
    progs = {}
    for w in range(WARPS):
        wg = w // 4
        ops = []
        for it in range(n_tiles):
            L0 = it * nl
            for j in range(nq):
                ops.append(("wait", L0 + j))
                if j > 0 and not kept(j - 1):
                    ops.append(("release", L0 + j - 1))
            if not kept(nq - 1):
                ops.append(("release", L0 + nq - 1))
            if wg == 0:
                if it > 0:
                    ops.append(("sync", "PEmpty", it))
                ops.append(("arrive", "PFull", it))
            else:
                ops.append(("sync", "PFull", it))
                if it + 1 < n_tiles:
                    ops.append(("arrive", "PEmpty", it + 1))
            if not held:
                ops += [("wait", L0 + product(u)) for u in range(nv)]
            ops += [("release", L0 + product(u)) for u in range(nv)]
        progs[w] = ops
    if ns is None:
        ns = _stages(lambda s: dkdv_smem(nq, s))
    return progs, ns, n_tiles * nl


def wgmma_dq(d, n_tiles, ns=None):
    """wgmma_wide_dq_kernel: a tile is its nq score stages (K and V box of
    a unit), then its product pairs (K units 2p, 2p + 1); warpgroup 0 S
    and P, warpgroup 1 dP and dS, behind PFull and DsFull; every warp
    waits for each product stage, whether it reads a unit there or not."""
    nq = _plan(d)[0]
    np_ = (nq + 1) // 2
    nl = nq + np_
    progs = {}
    for w in range(WARPS):
        wg = w // 4
        ops = []
        for it in range(n_tiles):
            L0 = it * nl
            for j in range(nq):  # each unit's product done before the next
                ops += [("wait", L0 + j), ("release", L0 + j)]
            if wg == 0:
                ops += [("arrive", "PFull", it), ("sync", "DsFull", it)]
            else:
                ops += [("sync", "PFull", it), ("arrive", "DsFull", it)]
            ops += [("wait", L0 + nq + p) for p in range(np_)]
            ops += [("release", L0 + nq + p) for p in range(np_)]
        progs[w] = ops
    if ns is None:
        ns = _stages(lambda s: dkdv_smem(nq, s))
    return progs, ns, n_tiles * nl


# --- the float32 forward's program ---------------------------------------

def f32_fwd(d, n_tiles, end_on_pair_barrier=False):
    """flash_fwd_wide_mma.cuh's wide_fwd_kernel: group g (warps 4g ..
    4g + 3) syncs its ring barrier once a chunk (its score chunks, then
    its output chunks); the warps of rows 16m.. hand partial S (group 1
    to 0) and P (0 to 1) over pair barriers; the denominators go over
    __syncthreads (``end_on_pair_barrier``: over the P barrier again)."""
    na = -(-d // 64)
    progs = {}
    for w in range(WARPS):
        g, m = divmod(w, 4)
        nc = (na - g + 1) // 2
        ops, i = [], 0
        for it in range(n_tiles):
            for _ in range(nc):
                ops.append(("sync", ("ring", g), i))
                i += 1
            if g == 0:
                ops += [("sync", ("partial", m), it),
                        ("arrive", ("probs", m), it)]
            else:
                ops += [("arrive", ("partial", m), it),
                        ("sync", ("probs", m), it)]
            for _ in range(nc):
                ops.append(("sync", ("ring", g), i))
                i += 1
        if end_on_pair_barrier:
            ops.append(("arrive" if g == 0 else "sync", ("probs", m), "end"))
        ops.append(("sync", "block", "end"))
        progs[w] = ops
    return progs


BARRIER_WARPS = {"PFull": 8, "PEmpty": 8, "DsFull": 8, "block": 8}


def _barrier_warps(bid):
    if bid in BARRIER_WARPS:
        return BARRIER_WARPS[bid]
    return 4 if bid[0] == "ring" else 2  # a group's ring; a warp pair


class Fault(AssertionError):
    pass


def run(progs, ns=0, total=0, seed=0):
    """One random interleaving of the warps' programs; raises Fault on a
    deadlock, a stage read holding another load, or a barrier generation
    that joins two steps."""
    rnd = random.Random(seed)
    # each warp's pace in this run: some warps fall far behind
    pace = {w: rnd.random() ** 4 + 1e-3 for w in progs}
    pc = {w: 0 for w in progs}
    landed = [0] * max(ns, 1)  # completed phases of each stage's barrier
    holds = {}                 # stage -> the load issued into it
    in_flight = []             # issued loads not landed yet
    count = [0] * max(ns, 1)
    bars = {}                  # bid -> [arrived warps, labels, waiting]
    blocked = {}               # warp -> (bid, generation) it waits on
    gens = {}

    def issue(L):
        s = L % ns
        assert L // ns == landed[s], "stage refilled before it landed"
        holds[s] = L
        in_flight.append(L)

    for L in range(min(ns, total)):
        issue(L)

    def runnable(w):
        if pc[w] >= len(progs[w]):
            return False
        if w in blocked:
            bid, gen = blocked[w]
            return gens.get(bid, 0) > gen
        op = progs[w][pc[w]]
        if op[0] == "wait":
            s = op[1] % ns
            return landed[s] % 2 != (op[1] // ns) % 2
        return True

    while True:
        ready = [w for w in progs if runnable(w)]
        if not ready and not in_flight:
            if all(pc[w] >= len(progs[w]) for w in progs):
                return
            raise Fault(f"deadlock at {[progs[w][pc[w]] for w in progs if pc[w] < len(progs[w])]}")
        if in_flight and (not ready or rnd.random() < 0.3):
            L = in_flight.pop(rnd.randrange(len(in_flight)))
            landed[L % ns] += 1
            continue
        w = rnd.choices(ready, [pace[w] for w in ready])[0]
        if w in blocked:
            del blocked[w]
            pc[w] += 1
            continue
        op = progs[w][pc[w]]
        if op[0] == "wait":
            s = op[1] % ns
            if holds.get(s) != op[1] or landed[s] != op[1] // ns + 1:
                raise Fault(f"warp {w} read stage {s} for load {op[1]} "
                            f"holding load {holds.get(s)}")
            pc[w] += 1
        elif op[0] == "release":
            s = op[1] % ns
            count[s] += 1
            if count[s] == WARPS:
                count[s] = 0
                if op[1] + ns < total:
                    issue(op[1] + ns)
            pc[w] += 1
        else:
            kind, bid, label = op
            bars.setdefault(bid, [0, set()])
            bars[bid][0] += 1
            bars[bid][1].add(label)
            gen = gens.get(bid, 0)
            if bars[bid][0] == _barrier_warps(bid):
                if len(bars[bid][1]) != 1:
                    raise Fault(f"barrier {bid} joined steps "
                                f"{sorted(map(str, bars[bid][1]))}")
                bars[bid] = [0, set()]
                gens[bid] = gen + 1
            if kind == "sync" and gens.get(bid, 0) == gen:
                blocked[w] = (bid, gen)
            else:
                pc[w] += 1


SEEDS = range(12)
DIMS = (136, 256, 264, 384, 512)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("kernel", ["fwd", "dkdv", "dq"])
def test_wgmma_wide_rings_complete(kernel, d):
    """Every slice of every wgmma kernel at its launcher's stage count
    completes under random interleavings, each wait finding its load."""
    nz = _plan(d)[1] if kernel != "dq" else 1
    for z in range(nz):
        if kernel == "fwd":
            progs, ns, total = wgmma_fwd(d, 3, z)
        elif kernel == "dkdv":
            progs, ns, total = wgmma_dkdv(d, 3, z)
        else:
            progs, ns, total = wgmma_dq(d, 3)
        assert ns >= 2
        for seed in SEEDS:
            run(progs, ns, total, seed)


@pytest.mark.parametrize("d", (256, 264, 512))
def test_wgmma_wide_launchers_stage_minimums(d):
    """Below the stage counts the launchers check the held stages
    deadlock: K3a's last slice holds its units (the launcher asks for a
    slice's units at most, ``per``), dQ's tile holds its product pairs;
    with as many stages as are held they complete."""
    nq, nz, per = _plan(d)
    held = nq - (nz - 1) * per  # the last slice's units, held
    assert held <= per
    progs, _, total = wgmma_dkdv(d, 2, nz - 1, ns=held)
    run(progs, held, total)
    progs, _, total = wgmma_dkdv(d, 2, nz - 1, ns=held - 1)
    with pytest.raises(Fault, match="deadlock"):
        run(progs, held - 1, total)
    np_ = (nq + 1) // 2
    progs, _, total = wgmma_dq(d, 2, ns=np_)
    run(progs, np_, total)
    progs, _, total = wgmma_dq(d, 2, ns=np_ - 1)
    with pytest.raises(Fault, match="deadlock"):
        run(progs, np_ - 1, total)


@pytest.mark.parametrize("d", (132, 136, 256, 264, 384, 512))
def test_f32_wide_forward_barriers_complete(d):
    """The float32 forward's rings and pair barriers complete under random
    interleavings with every generation joining one step; handing the
    denominators over the P barrier once more at the end (not done) can
    join two steps' arrivals."""
    for seed in SEEDS:
        run(f32_fwd(d, 3), seed=seed)
    with pytest.raises(Fault, match="joined steps"):
        for seed in range(200):
            run(f32_fwd(d, 3, end_on_pair_barrier=True), seed=seed)
