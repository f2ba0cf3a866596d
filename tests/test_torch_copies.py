"""The port's copies of the JAX package's host modules, pinned.

``repro_torch.core`` carries the reference's host modules as copies: the
catalog, the changelog, the policy language and engine, telemetry, the
stats, grants, profiles and reports. With ``repro_torch`` renamed to
``repro``, ``types``, ``fidtable`` and ``changelog`` must equal the
reference byte for byte, and every other module may differ only in the
hunks listed here: one docstring line for ``catalog``, ``policy``,
``stats`` and ``grants``; for ``telemetry``, ``policy_engine``,
``profiles`` and ``reports`` the lines where they touch a device (the
span's ``torch.cuda.synchronize()`` on CUDA tensors, ``device=`` resolved
and passed to the port's ops) and the docstrings that name the kernels.
Any further drift, on either side, fails. (``tests/test_torch_collect.py``
pins the collect plane's copies the same way.)
"""
import difflib
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
IDENTICAL = ["types", "fidtable", "changelog"]

# module -> [(the reference's lines, the port's lines)], in file order
HUNKS = {
    "catalog": [
        ([
            '  ``policy_scan`` Pallas kernel on TPU;',
        ],
         [
             '  ``policy_scan`` CUDA kernel on the GPU;',
         ]),
    ],
    "policy": [
        ([
            '   the ``policy_scan`` Pallas TPU kernel (numeric/categorical predicates).',
        ],
         [
             '   the ``policy_scan`` CUDA kernel (numeric/categorical predicates).',
         ]),
    ],
    "stats": [
        ([
            ':class:`~repro.core.device_store.DeviceColumnStore` cube plane',
        ],
         [
             'device column store cube plane',
         ]),
    ],
    "grants": [
        ([
            '* the :class:`~repro.core.device_store.DeviceColumnStore` permissions',
        ],
         [
             '* the device column store permissions',
         ]),
    ],
    "telemetry": [
        ([
            '``span.block_on(arrays)``) calls ``jax.block_until_ready`` at close and',
        ],
         [
             '``span.block_on(tensors)``) calls ``torch.cuda.synchronize()`` at close and',
         ]),
        ([],
         [
             'def _holds_cuda(obj) -> bool:',
             '    """True when ``obj`` (a tensor or a nest of lists/tuples/dicts of',
             '    tensors) holds at least one CUDA tensor."""',
             '    if isinstance(obj, dict):',
             '        return any(_holds_cuda(v) for v in obj.values())',
             '    if isinstance(obj, (list, tuple)):',
             '        return any(_holds_cuda(v) for v in obj)',
             '    return bool(getattr(obj, "is_cuda", False))',
             '',
             '',
         ]),
        ([
            '        """Opt into a device sync at span close: ``jax.block_until_ready``',
            '        over ``arrays`` runs before the clock is read, and the wait is',
            "        recorded in ``sync_wait`` — so the span's wall time covers the",
        ],
         [
             '        """Opt into a device sync at span close: when ``arrays`` holds CUDA',
             '        tensors, ``torch.cuda.synchronize()`` runs before the clock is',
             "        read, and the wait is recorded in ``sync_wait`` — so the span's",
             '        wall time covers the',
         ]),
        ([
            '            import jax',
            '            jax.block_until_ready(self._sync)',
        ],
         [
             '            if _holds_cuda(self._sync):',
             '                import torch',
             '                torch.cuda.synchronize()',
         ]),
    ],
    "policy_engine": [
        ([
            '  (vectorized column masks), ``"policy_scan"`` (the Pallas TPU kernel,',
            '  falling back to its jitted oracle off-TPU) or ``"policy_scan_mesh"``',
        ],
         [
             '  (vectorized column masks), ``"policy_scan"`` (the hand-written CUDA',
             "  kernel on the engine's CUDA device, its plain PyTorch version when the",
             '  engine runs on ``device="cpu"``) or ``"policy_scan_mesh"``',
         ]),
        ([],
         [
             'from ..device import resolve_device',
         ]),
        ([
            '    def __init__(self, catalog: Catalog, clock: Callable[[], float] = time.time',
            '                 ) -> None:',
        ],
         [
             '    def __init__(self, catalog: Catalog, clock: Callable[[], float] = time.time,',
             '                 device=None) -> None:',
         ]),
        ([],
         [
             '        # the kernel evaluators run here: "cuda" unless told otherwise,',
             '        # raising when there is no usable card (never a silent CPU run)',
             '        self.device = resolve_device(device)',
         ]),
        ([
            '        """Wire a :class:`~repro.core.device_store.DeviceColumnStore` so the',
            '        ``policy_scan_mesh`` evaluator can match data-parallel over the',
        ],
         [
             '        """Wire a :class:`~repro.core.device_store.DeviceColumnStore`',
             '        so the ``policy_scan_mesh`` evaluator can match over the',
         ]),
        ([
            '                    self.catalog.strings, now)',
        ],
         [
             '                    self.catalog.strings, now, device=self.device)',
         ]),
    ],
    "profiles": [
        ([
            '  (exact int64, the default) or the fused ``profile_cube`` Pallas kernel',
        ],
         [
             '  (exact int64, the default) or the fused ``profile_cube`` CUDA kernel',
         ]),
        ([
            '  f32 accumulation, see :attr:`ProfileCube.use_kernel`);',
        ],
         [
             '  cells rounded to f32, see :attr:`ProfileCube.use_kernel`);',
         ]),
        ([
            'to the :class:`~repro.core.device_store.DeviceColumnStore` cube plane —',
        ],
         [
             'to the device column store cube plane —',
         ]),
        ([],
         [
             'from ..device import resolve_device',
         ]),
        ([
            '                 use_kernel: bool = False) -> None:',
        ],
         [
             '                 use_kernel: bool = False, device=None) -> None:',
         ]),
        ([
            '        # True: full rebuilds run through the Pallas kernel (on TPU; the',
            '        # interpret-mode kernel off-TPU is for differential tests). The',
            '        # kernel accumulates in f32 — exact only while per-cell sums stay',
            '        # below 2**24 — so the DEFAULT is the int64 host groupby; opt in',
            '        # for on-device builds where that precision envelope holds (or',
            '        # approximate trends are acceptable).',
        ],
         [
             '        # True: full rebuilds run through the profile_cube op on',
             '        # ``device`` (the CUDA kernel on the card; its plain PyTorch',
             '        # version when the cube runs on device="cpu", as the differential',
             '        # tests do). Cells come back as f32 — exact only while per-cell',
             '        # sums stay below 2**24 — so the DEFAULT is the int64 host groupby;',
             '        # opt in for on-device builds where that precision envelope holds',
             '        # (or approximate trends are acceptable).',
         ]),
        ([],
         [
             '        # the profile_cube op runs here: "cuda" unless told otherwise,',
             '        # raising when there is no usable card (never a silent CPU run)',
             '        self.device = resolve_device(device)',
         ]),
        ([
            '        default), or the fused Pallas kernel when opted in (f32 sums —',
        ],
         [
             '        default), or the fused CUDA kernel when opted in (f32 cells —',
         ]),
        ([
            '                        ab=age_buckets_np(age), n_groups=len(self.groups))',
        ],
         [
             '                        ab=age_buckets_np(age), n_groups=len(self.groups),',
             '                        device=self.device)',
         ]),
    ],
    "reports": [
        ([
            'additionally go **mesh-resident**: predicates evaluate and top-k/range',
            "aggregates reduce over the device store's sharded column blocks under",
            "``shard_map``, and only the winning rows' paths come back through the",
            "store's host mirrors — a warm query never calls ``Catalog.arrays()``.",
        ],
         [
             'additionally go **store-resident**: predicates evaluate and top-k/range',
             'aggregates reduce over the resident ``(D, C+1+4, Rp)`` tensor of a',
             ':class:`~repro.core.device_store.DeviceColumnStore` on its device,',
             "and only the winning rows' paths come back through the store's host",
             'mirrors — a warm query never calls ``Catalog.arrays()``.',
         ]),
        ([
            'byte-identical differential oracle (``tests/core/test_mesh_reports.py``).',
        ],
         [
             'byte-identical differential oracle (``tests/test_torch_mesh_reports.py``).',
         ]),
        ([
            '        :class:`~repro.core.device_store.DeviceColumnStore`.',
        ],
         [
             '        device column store.',
         ]),
    ],
}


def _hunks(name):
    ref = (SRC / "repro" / "core" / f"{name}.py").read_text().splitlines()
    port = (SRC / "repro_torch" / "core" / f"{name}.py").read_text()
    port = port.replace("repro_torch", "repro").splitlines()
    sm = difflib.SequenceMatcher(None, ref, port, autojunk=False)
    return [(ref[i1:i2], port[j1:j2])
            for tag, i1, i2, j1, j2 in sm.get_opcodes() if tag != "equal"]


@pytest.mark.parametrize("name", IDENTICAL)
def test_copies_equal_the_reference(name):
    ref = (SRC / "repro" / "core" / f"{name}.py").read_text()
    port = (SRC / "repro_torch" / "core" / f"{name}.py").read_text()
    assert port.replace("repro_torch", "repro") == ref


@pytest.mark.parametrize("name", sorted(HUNKS))
def test_copies_differ_only_in_the_listed_hunks(name):
    assert _hunks(name) == [(list(a), list(b)) for a, b in HUNKS[name]]


def test_one_docstring_line_where_the_kernels_are_named():
    for name in ("catalog", "policy", "stats", "grants"):
        (ref, port), = HUNKS[name]
        assert len(ref) == len(port) == 1, name
