"""policy_scan's staged columns and decoded programs, and the redesigned
kernel on the card.

Each block of the kernel works out from its programs which columns it
stages in shared memory (``stage_plan`` in ``csrc/policy_scan.cuh``: size,
blocks, valid and every column a live compare reads) and how a ring of
104 KB holds them (``ring_shape``: a whole tile of rows a stage, or a half
or a quarter of one for wide sets). Where a host C++ compiler exists, those
functions and the kernel's decoder and interpreter are built for the host
and held to what they must give: the staged set is exactly the read set;
the programs remapped to its slots, run through the plain version on the
staged sub-table, give masks identical to the JAX package's
``policy_scan_batch`` reference on the whole table (seeded random programs
with NOP padding, an empty program and an unknown opcode, kept within the
8-slot stack where the reference and the port agree); every width up to
the kernel's 96 columns fits the ring; and the interpreter equals the plain
version bit for bit.

Tests marked ``cuda`` hold the kernel to the plain version on the card: R
from 1 to 17 (passes of 8), ragged and unaligned N, a column view whose
base is not 16 B aligned, programs that read every column of the catalog
(half-tile stages) and of 40- and 96-column tables (quarter-tile stages),
sizes that are not integers (aggregates within ``rtol=1e-5, atol=1``), a
validity column that is not 0/1, repeat calls bit for bit, and each
program's R = 1 aggregates bit-equal to its row of the batch whatever the
stage shape of either launch.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.catalog import StringTable
from repro_torch.core.policy import (KERNEL_COLUMNS, OP_CMP_GE, OP_CMP_LT,
                                     OP_OR, compile_programs, parse_expr)
from repro_torch.kernels.policy_scan import kernel as tk
from repro_torch.kernels.policy_scan import ops as tops
from repro_torch.kernels.policy_scan import ref as tref

SIZE = KERNEL_COLUMNS.index("size")
BLOCKS = KERNEL_COLUMNS.index("blocks")
N_COLS = len(KERNEL_COLUMNS) + 1          # the kernel columns and validity
VALID = N_COLS - 1
KW = dict(size_col=SIZE, blocks_col=BLOCKS, valid_col=VALID)
TOL = dict(rtol=1e-5, atol=1)
EXPRS = ["(size > 1GB or owner == 'u1') and type == file", "size > 1GB",
         "owner == 'u1'", "not (type == file and size <= 32M)",
         "last_access > 90d", "nlink == 2 or ost_idx == 3",
         "mode >= 256 and not (dirty == 1)", "group == 1 and pool != 2"]
# programs that read all 16 kernel columns (17 staged with validity)
WIDE_EXPRS = [
    "(size > 1GB or blocks < 4096) and (nlink == 2 or ost_idx == 3 or "
    "archive_id == 1) or (mode >= 256 and dirty == 1) or last_access > 90d "
    "or last_mod > 30d or creation > 1d or type == file or "
    "hsm_state == archived or owner == 'u1' or group == 'u2' or "
    "pool == 'u0' or status == 'u1'",
    "size <= 32M and blocks >= 8 and nlink != 1 and ost_idx < 5 and "
    "archive_id != 2 and mode < 448 and dirty == 0 and "
    "not (last_access > 10d and last_mod > 20d and creation > 30d) and "
    "type == file and hsm_state != released and owner != 'u0' and "
    "(group == 'u1' or pool == 'u2' or status != 'u0')"]
CSRC = Path(tk.__file__).resolve().parent / "csrc"


def random_programs(rng, r, p, n_cols):
    """(ops, colidx, operands), (r, p): random postfix programs whose stack
    stays within 8 slots (NOT and AND may hit an empty stack), NOP padded;
    program 1 is empty and one instruction of program 2 has an unknown
    opcode."""
    ops = np.full((r, p), -1, np.int32)
    col = np.zeros((r, p), np.int32)
    opr = np.zeros((r, p), np.float32)
    for i in range(r):
        sp, length = 0, 0 if i == 1 else int(rng.integers(1, p + 1))
        for k in range(length):
            if rng.random() < 0.15:
                continue                                   # NOP
            if i == 2 and k == length // 2:
                op = 11                                    # unknown opcode
            elif sp < 7 and (sp < 2 or rng.random() < 0.5):
                op = int(rng.integers(0, 6))
            else:
                op = int(rng.integers(6, 9))
            ops[i, k] = op
            col[i, k] = rng.integers(0, n_cols)
            opr[i, k] = rng.integers(0, 4)
            sp += 1 if op < 6 else (0 if op == 8 else -1)
    return ops, col, opr


def small_cols(rng, n, n_cols):
    cols = rng.integers(0, 4, (n_cols, n)).astype(np.float32)
    cols[VALID] = rng.random(n) < 0.9
    return cols


HOST_PLAN = r"""
#include <cstdio>
#include <vector>
#include "policy_scan.cuh"
using namespace policy_scan;
// stdin: n_cols count size_col blocks_col valid_col, ops, colidx;
// stdout: the staged columns, then the ring's items, stages and seg
int main() {
  int n_cols, count, size_col, blocks_col, valid_col;
  if (scanf("%d %d %d %d %d", &n_cols, &count, &size_col, &blocks_col,
            &valid_col) != 5) return 1;
  std::vector<int> ops(count), col(count), stage(MAX_COLS);
  for (auto& v : ops) scanf("%d", &v);
  for (auto& v : col) scanf("%d", &v);
  const int n = stage_plan(ops.data(), col.data(), count, n_cols, size_col,
                           blocks_col, valid_col, stage.data());
  for (int s = 0; s < n; ++s) printf("%d ", stage[s]);
  const Ring g = ring_shape(n);
  printf("\n%d %d %d\n", g.items, g.stages, g.seg);
  return 0;
}
"""


HOST_RING = r"""
#include <cstdio>
#include "policy_scan.cuh"
using namespace policy_scan;
// stdin: column counts; stdout: each one's ring items, stages and seg,
// after a first line of THREADS ITEMS RING_FLOATS MAX_STAGES MAX_COLS
int main() {
  printf("%d %d %d %d %d\n", THREADS, ITEMS, RING_FLOATS, MAX_STAGES,
         MAX_COLS);
  int n;
  while (scanf("%d", &n) == 1) {
    const Ring g = ring_shape(n);
    printf("%d %d %d\n", g.items, g.stages, g.seg);
  }
  return 0;
}
"""


HOST_MAIN = r"""
#include <cstdio>
#include <vector>
#include "policy_scan.cuh"
using namespace policy_scan;
constexpr int STRIDE = 1000;   // slot s at s * STRIDE + s % 4, as the kernel
// stdin: n_cols n n_instr staged, ops, colidx, operands, columns; stdout:
// each row's result bit. staged 1: compares find their column through the
// slots of stage_plan (size 0, blocks 1, no validity); 0: by column.
int main() {
  int n_cols, n, p, staged;
  if (scanf("%d %d %d %d", &n_cols, &n, &p, &staged) != 4) return 1;
  std::vector<int> ops(p), col(p), stage(MAX_COLS), where(MAX_COLS, -1);
  std::vector<float> opr(p), cols(static_cast<size_t>(n_cols) * n);
  for (auto& v : ops) scanf("%d", &v);
  for (auto& v : col) scanf("%d", &v);
  for (auto& v : opr) scanf("%f", &v);
  for (auto& v : cols) scanf("%f", &v);
  int ns = 0;
  if (staged) {
    ns = stage_plan(ops.data(), col.data(), p, n_cols, 0, 1, -1,
                    stage.data());
    for (int s = 0; s < ns; ++s) where[stage[s]] = s * STRIDE + s % 4;
  } else {
    for (int c = 0; c < n_cols; ++c) where[c] = c;
  }
  std::vector<uint32_t> code(p + 1);
  std::vector<float> o(p + 1);
  int final_pos;
  const int len = decode_program(ops.data(), col.data(), opr.data(), p,
                                 n_cols, where.data(), code.data(), o.data(),
                                 &final_pos);
  for (int r0 = 0; r0 < n; r0 += 4) {
    uint32_t bit[4];
    eval_program<4>(code.data(), o.data(), len, final_pos,
                    [&](int j, int at) {
                      const int row = r0 + j;
                      if (row >= n || at < 0) return -1e30f;
                      int c = at;
                      if (staged) {
                        const int s = at / STRIDE;
                        if (s >= ns || at != s * STRIDE + s % 4)
                          return -1e30f;
                        c = stage[s];
                      }
                      return cols[static_cast<size_t>(c) * n + row];
                    },
                    bit);
    for (int j = 0; j < 4 && r0 + j < n; ++j) printf("%u\n", bit[j]);
  }
  return 0;
}
"""


HOST_BUCKETS = r"""
#include <cstdio>
#include "policy_scan.cuh"
// stdin: float bit patterns (u32); stdout: each one's size bucket
int main() {
  unsigned u;
  while (scanf("%u", &u) == 1) {
    float f;
    memcpy(&f, &u, sizeof f);
    printf("%d\n", policy_scan::size_bucket(f));
  }
  return 0;
}
"""


def host_build(tmp_path_factory, name, text):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build csrc/policy_scan.cuh")
    d = tmp_path_factory.mktemp(f"policy_scan_{name}")
    (d / "main.cpp").write_text(text)
    exe = d / name
    subprocess.run([cxx, "-O1", "-std=c++17", f"-I{CSRC}", "-o", str(exe),
                    str(d / "main.cpp")], check=True, capture_output=True,
                   timeout=120)
    return exe


def run_host(exe, values) -> str:
    return subprocess.run([str(exe)], input=" ".join(str(v) for v in values),
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout


@pytest.fixture(scope="module")
def host_plan(tmp_path_factory):
    """The kernel's stage_plan and ring_shape, built for the host:
    (ops, colidx, n_cols, size_col, blocks_col, valid_col) -> (staged
    columns, (items, stages, seg))."""
    exe = host_build(tmp_path_factory, "plan", HOST_PLAN)

    def plan(ops, colidx, *, n_cols, size_col, blocks_col, valid_col):
        ops = np.asarray(ops, np.int32).ravel()
        colidx = np.asarray(colidx, np.int32).ravel()
        out = run_host(exe, [n_cols, ops.size, size_col, blocks_col,
                             valid_col, *ops.tolist(), *colidx.tolist()])
        stage, ring = out.split("\n")[:2]
        return (tuple(int(c) for c in stage.split()),
                tuple(int(v) for v in ring.split()))
    return plan


def slots_of(stage, ops, colidx, n_cols):
    """Each live compare's slot in ``stage`` (other instructions: 0)."""
    index = {c: s for s, c in enumerate(stage)}
    live = (ops >= 0) & (ops < 6)
    slots = np.zeros(colidx.shape, np.int32)
    slots[live] = [index[c] for c in
                   np.clip(colidx[live], 0, n_cols - 1).tolist()]
    return slots


@pytest.mark.parametrize("valid_col", [VALID, -1], ids=["valid", "novalid"])
@pytest.mark.parametrize("seed", range(4))
def test_stage_plan_is_the_read_set(host_plan, seed, valid_col):
    rng = np.random.default_rng(seed)
    ops, col, _ = random_programs(rng, 5, 12, N_COLS)
    col[0, 0] = N_COLS + 3                       # clamped, as the kernel does
    col[3, :] = -2
    kw = dict(KW, valid_col=valid_col)
    stage, _ = host_plan(ops, col, n_cols=N_COLS, **kw)
    live = (ops >= 0) & (ops < 6)
    read = set(np.clip(col[live], 0, N_COLS - 1).tolist())
    want = read | {SIZE, BLOCKS} | ({valid_col} if valid_col >= 0 else set())
    assert len(stage) == len(set(stage)) and set(stage) == want
    assert stage[:2] == (SIZE, BLOCKS)
    if valid_col >= 0:
        assert stage[2] == valid_col
    elif VALID not in read:
        assert VALID not in stage
    one, _ = host_plan(ops[0], col[0], n_cols=N_COLS, **kw)
    assert set(one) <= set(stage)


@pytest.mark.parametrize("seed", range(6))
def test_staged_programs_match_jax(host_plan, seed):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.policy_scan import ref as jref
    rng = np.random.default_rng(100 + seed)
    n = 257
    cols = small_cols(rng, n, N_COLS)
    ops, col, opr = random_programs(rng, 6, 10, N_COLS)
    stage, _ = host_plan(ops, col, n_cols=N_COLS, **KW)
    slots = slots_of(stage, ops, col, N_COLS)
    sub = torch.from_numpy(cols[list(stage)])
    masks, rule, _ = tref.policy_scan_batch_ref(
        sub, torch.from_numpy(ops), torch.from_numpy(slots),
        torch.from_numpy(opr), size_col=0, blocks_col=stage.index(BLOCKS),
        valid_col=stage.index(VALID))
    jm, jr, _ = jref.policy_scan_batch_ref(
        *(jnp.asarray(a) for a in (cols, ops, col, opr)), **KW)
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(rule.numpy(), np.asarray(jr))
    assert not masks[1].any()                    # the empty program


@pytest.mark.parametrize("n_stage", [1, 3, 5, 12, 13, 17, 25, 26, 40, 51,
                                     52, 96])
def test_ring_holds_every_width(tmp_path_factory, n_stage):
    """Every column count up to the kernel's limit fits the ring: the
    widest stage (1024, 512 or 256 rows) that leaves 2 stages, else 256
    rows with the stages that fit; each segment holds its rows and the up
    to 3 floats its copy starts before them, 16 B aligned."""
    exe = host_build(tmp_path_factory, "ring", HOST_RING)
    head, line = run_host(exe, [n_stage]).split("\n")[:2]
    threads, items_max, ring, max_stages, max_cols = map(int, head.split())
    items, stages, seg = map(int, line.split())
    assert max_cols == 96 and n_stage <= max_cols
    assert items in (1, 2, 4) and items <= items_max
    assert seg == items * threads + 4 and seg % 4 == 0
    assert 1 <= stages <= max_stages
    assert n_stage * seg * stages <= ring
    wider = [i for i in (4, 2, 1) if i > items]
    for i in wider:                     # no wider stage leaves 2 stages
        assert ring // (n_stage * (i * threads + 4)) < 2
    if stages < 2:
        assert items == 1
    assert (items == 4) == (n_stage <= 12)


def test_kernel_size_bucket_matches_plain_version(tmp_path_factory):
    """The kernel's bucket from the binary exponent equals the plain
    version's count of edges at or below the size, at and around every
    edge, for signs, zero, NaN, infinities and log-uniform sizes."""
    exe = host_build(tmp_path_factory, "buckets", HOST_BUCKETS)
    edges = np.asarray(tref.EDGES, np.float32)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(-np.inf)),
                           np.nextafter(edges, np.float32(np.inf))])
    rng = np.random.default_rng(9)
    sizes = np.concatenate([
        near, -near, np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-42,
                                 3.4e38]),
        (2.0 ** rng.uniform(-10, 50, 4000)).astype(np.float32)])
    out = run_host(exe, sizes.view(np.uint32).tolist()).split()
    want = tref.size_buckets(torch.from_numpy(sizes))
    np.testing.assert_array_equal(np.asarray(out, np.int64), want.numpy())


@pytest.fixture(scope="module")
def host_interpreter(tmp_path_factory):
    return host_build(tmp_path_factory, "interp", HOST_MAIN)


@pytest.mark.parametrize("seed", range(4))
def test_kernel_interpreter_matches_plain_version(host_interpreter, seed):
    """The kernel's staging plan, decoder and interpreter, built for the
    host, against ``ref.eval_program``, compare columns read through the
    slots of the staged set and, unstaged, by column; stacks here run past
    8 slots too, where both clamp."""
    rng = np.random.default_rng(200 + seed)
    n, n_cols = 37, 6
    cols = rng.integers(0, 4, (n_cols, n)).astype(np.float32)
    for _ in range(40):
        p = int(rng.integers(0, 16))
        ops = rng.integers(-1, 12, p).astype(np.int32)
        col = rng.integers(-2, n_cols + 2, p).astype(np.int32)
        opr = rng.integers(0, 4, p).astype(np.float32)
        want = tref.eval_program(*(torch.from_numpy(a)
                                   for a in (cols, ops, col, opr)))
        for staged in (1, 0):
            out = run_host(host_interpreter, (
                n_cols, n, p, staged, *ops.tolist(), *col.tolist(),
                *opr.tolist(), *cols.ravel().tolist())).split()
            np.testing.assert_array_equal(np.asarray(out, np.float32),
                                          want.numpy())


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the policy_scan kernels run only "
                    "there")
    return torch.device("cuda")


def card_programs(r, device, wide=False):
    """r programs of EXPRS; with ``wide``, every third one (program 0
    first) reads all 16 kernel columns."""
    st = StringTable()
    for s in ("u0", "u1", "u2"):
        st.intern(s)
    exprs = [WIDE_EXPRS[i // 3 % 2] if wide and i % 3 == 0
             else EXPRS[i % len(EXPRS)] for i in range(r)]
    host = compile_programs([parse_expr(e) for e in exprs], st, now=1e6)
    return [torch.from_numpy(a).to(device) for a in host]


def card_cols(n, seed, device, integer=True):
    rng = np.random.default_rng(seed)
    cols = np.zeros((N_COLS, n), np.float32)
    for c in range(len(KERNEL_COLUMNS)):
        cols[c] = rng.integers(0, 8, n)
    cols[SIZE] = rng.integers(0, 1 << 32, n)
    cols[BLOCKS] = rng.integers(0, 1 << 24, n)
    cols[KERNEL_COLUMNS.index("atime")] = 1e6 - rng.integers(0, 2e7, n)
    if not integer:
        cols[SIZE] = rng.random(n) * 2.0 ** 40
        cols[BLOCKS] = rng.random(n) * 1e3
    cols[VALID] = rng.random(n) < 0.95
    return torch.from_numpy(cols).to(device)


def chain_program(columns, p):
    """(ops, colidx, operands), (p,): ``c0 >= 2 or c1 < 1 or ...`` over
    ``columns``, NOP padded to p instructions."""
    ops = np.full(p, -1, np.int32)
    col = np.zeros(p, np.int32)
    opr = np.zeros(p, np.float32)
    k = 0
    for i, c in enumerate(columns):
        ops[k], col[k], opr[k] = (OP_CMP_GE, c, 2) if i % 2 else \
            (OP_CMP_LT, c, 1)
        k += 1
        if i:
            ops[k] = OP_OR
            k += 1
    return ops, col, opr


def table_programs(n_cols, r, seed, device):
    """r programs over an n_cols table: program 0 reads every column, the
    others are random_programs."""
    rng = np.random.default_rng(seed)
    p = 2 * n_cols
    ops, col, opr = random_programs(rng, r, p, n_cols)
    ops[0], col[0], opr[0] = chain_program(range(n_cols), p)
    return [torch.from_numpy(a).to(device) for a in (ops, col, opr)]


def table_cols(n_cols, n, seed, device):
    """(n_cols, n): size (column 0) and blocks (1) as card_cols makes them,
    small integers elsewhere, validity in the last column."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 4, (n_cols, n)).astype(np.float32)
    cols[0] = rng.integers(0, 1 << 32, n)
    cols[1] = rng.integers(0, 1 << 24, n)
    cols[-1] = rng.random(n) < 0.95
    return torch.from_numpy(cols).to(device)


def held_to_plain(cols, prog, **kw):
    got = tops.policy_scan_batch(cols, *prog, **kw)
    again = tops.policy_scan_batch(cols, *prog, **kw)
    want = tref.policy_scan_batch_ref(cols, *prog, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], **TOL)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 1023, 1025, 3000, 100_003])
@pytest.mark.parametrize("r", [1, 2, 4, 8, 9, 17])
def test_cuda_programs_and_rows(cuda_device, r, n):
    cols = card_cols(n, 1000 * r + n, cuda_device)
    prog = card_programs(r, cuda_device)
    held_to_plain(cols, prog, **KW)


def unaligned(cols):
    """cols as a contiguous view starting one float into its storage: no
    column start is 16 B aligned, so every copy starts at the boundary
    before it."""
    flat = torch.empty(cols.numel() + 1, device=cols.device)
    flat[1:] = cols.reshape(-1)
    view = flat[1:].view(cols.shape)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


def stage_rows(cols, prog, **kw):
    """The rows of a stage of each pass of the launch."""
    shape = tk.launch_shape(cols, prog[0], prog[1], **kw)
    return [p["stage_rows"] for p in shape["passes"]]


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["policy", "wide"])
@pytest.mark.parametrize("n", [1025, 100_003, 1 << 20])
def test_cuda_unaligned_column_view(cuda_device, n, wide):
    cols = unaligned(card_cols(n, 7, cuda_device))
    held_to_plain(cols, card_programs(4, cuda_device, wide=wide), **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1025, 100_003])
@pytest.mark.parametrize("r", [1, 9, 17])
def test_cuda_wide_programs(cuda_device, r, n):
    """Programs that read all 16 kernel columns: 17 staged columns, which
    leave 2 stages only at half a tile a stage."""
    cols = card_cols(n, 17 * r + n, cuda_device)
    prog = card_programs(r, cuda_device, wide=True)
    # a pass with a wide program (every third) stages half tiles
    want = [512 if any(i % 3 == 0 for i in range(p0, min(r, p0 + 8)))
            else 1024 for p0 in range(0, r, 8)]
    assert stage_rows(cols, prog, **KW) == want
    held_to_plain(cols, prog, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["aligned", "unaligned"])
@pytest.mark.parametrize("n", [1025, 100_003])
@pytest.mark.parametrize("n_cols", [40, 96])
def test_cuda_wide_tables(cuda_device, n_cols, n, view):
    """Tables of 40 and of 96 columns (the kernel's most) with a program
    that reads them all: quarter-tile stages, 2 of them and 1. Each
    program's R = 1 launch equals its row of the batch bit for bit."""
    cols = table_cols(n_cols, n, n_cols + n, cuda_device)
    if view == "unaligned":
        cols = unaligned(cols)
    prog = table_programs(n_cols, 9, n, cuda_device)
    kw = dict(size_col=0, blocks_col=1, valid_col=n_cols - 1)
    shape = tk.launch_shape(cols, prog[0], prog[1], **kw)
    first = shape["passes"][0]
    assert len(first["staged_cols"]) == n_cols
    assert first["stage_rows"] == 256
    assert first["stages"] == (2 if n_cols == 40 else 1)
    masks, _, agg = held_to_plain(cols, prog, **kw)
    for r in range(prog[0].shape[0]):
        m1, a1 = tops.policy_scan(cols, *(p[r] for p in prog), **kw)
        assert torch.equal(m1, masks[r])
        assert torch.equal(a1, agg[r])


@pytest.mark.cuda
def test_cuda_too_many_columns_raise(cuda_device):
    cols = torch.zeros((97, 8), device=cuda_device)
    prog = table_programs(8, 3, 0, cuda_device)
    with pytest.raises(ValueError, match="at most 96"):
        tops.policy_scan_batch(cols, *prog, size_col=0, blocks_col=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3000, 1 << 20])
def test_cuda_sizes_not_integers(cuda_device, n):
    cols = card_cols(n, 11, cuda_device, integer=False)
    held_to_plain(cols, card_programs(9, cuda_device), **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3000, 100_003])
def test_cuda_validity_not_0_1(cuda_device, n):
    """A validity column of 0, 0.25, 0.5, 1 and 2: masks (bit * valid) and
    rule index equal the plain version's, volume and spc_used are weighted
    by the mask (within TOL); count, histogram and any_match count the
    rows whose mask is not 0, where the plain version sums the mask: they
    equal the plain version's on the validity column's indicator."""
    cols = card_cols(n, 19, cuda_device)
    rng = np.random.default_rng(n)
    cols[VALID] = torch.from_numpy(
        rng.choice(np.float32([0, 0.25, 0.5, 1, 2]), n)).to(cuda_device)
    prog = card_programs(9, cuda_device)
    masks, rule, agg = tops.policy_scan_batch(cols, *prog, **KW)
    want = tref.policy_scan_batch_ref(cols, *prog, **KW)
    assert torch.equal(masks, want[0])
    assert torch.equal(rule, want[1])
    torch.testing.assert_close(agg[:, 1:3], want[2][:, 1:3], **TOL)
    ones = cols.clone()
    ones[VALID] = (cols[VALID] != 0).float()
    counted = tref.policy_scan_batch_ref(ones, *prog, **KW)[2]
    keep = [0, *range(3, agg.shape[1])]
    assert torch.equal(agg[:, keep], counted[:, keep])


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["policy", "wide"])
@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("n", [3000, 100_003, 1 << 20])
def test_cuda_single_program_equals_its_batch_row(cuda_device, n, integer,
                                                  wide):
    """Program r's aggregates do not depend on R or the launch's other
    programs: the R = 1 launch gives the batch's row r bit for bit, also
    where the batch's pass stages half tiles (``wide``) and program r
    alone stages whole ones."""
    cols = card_cols(n, 13, cuda_device, integer=integer)
    prog = card_programs(9, cuda_device, wide=wide)
    masks, _, agg = tops.policy_scan_batch(cols, *prog, **KW)
    for r in range(prog[0].shape[0]):
        m1, a1 = tops.policy_scan(cols, *(p[r] for p in prog), **KW)
        assert torch.equal(m1, masks[r])
        assert torch.equal(a1, agg[r])
