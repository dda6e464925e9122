"""The port's lint (``ceph_tpu_torch/analysis``) against the reference's
(``ceph_tpu/analysis``), plus the port's tier-1 gate.

Three kinds of check:

  * the backend-free families (CTL000, CTL110, CTL120, CTL13x, CTL3xx,
    CTL4xx, CTL5xx, CTL601, CTL603-605, CTL7xx, CTL8xx, CTL9xx) and the
    framework (noqa, baseline, registry, CLI): every test of
    ``tests/test_lint.py`` for them runs again with its ``runner`` handle
    swapped for one that lints each fixture tree with BOTH linters and
    requires identical findings (rule, relpath, line, message),
    identical noqa lists and identical stale entries, then hands the
    port's result to the reference test's own assertions; and both
    linters run once over the reference tree with those families;
  * the torch counterparts of the JAX-shaped rules (CTL101-103,
    CTL201-202, CTL602, CTL1001-1006): a positive and a negative torch
    fixture per id, each mirroring the reference's JAX fixture of the
    same id and flagging the matching line;
  * the gate on the port's own tree: every root of the device-path set
    the reference's jit roots name, the set's size, lint-clean with no
    stale baseline entry and at most 10 baselined, under the 30 s
    budget, and ``tools/check_static``'s smoke — one whole-tree run,
    shared by a module fixture.
"""
import inspect
import io
import json
import pathlib
import textwrap
import time

import pytest
import torch

import tests.test_lint as ref_tests
from ceph_tpu.analysis import astutil as ref_astutil
from ceph_tpu.analysis import runner as ref_runner
from ceph_tpu.analysis.core import Program as RefProgram
from ceph_tpu.analysis.core import parse_module as ref_parse
from ceph_tpu_torch.analysis import astutil
from ceph_tpu_torch.analysis import baseline as baseline_mod
from ceph_tpu_torch.analysis import core, runner
from ceph_tpu_torch.analysis.registry import RuleRegistry

# One intra-op thread per test process (the suite runs under several
# xdist workers; the whole-tree lint shares the cores with them).
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def write(tmp, rel, src):
    p = tmp / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return p


def lint(tmp, select=None, paths=None, evidence=None, baseline=None):
    return runner.run(str(tmp), paths=paths or ["."],
                      evidence_paths=evidence or [],
                      select=select, baseline=baseline)


def rules_of(res):
    return [f.rule for f in res.findings]


def keyed(res):
    """A lint result as plain tuples, comparable across the packages."""
    def rows(fs):
        return [(f.rule, f.path, f.line, f.msg) for f in fs]
    return (rows(res.findings), rows(res.baselined), rows(res.noqa),
            sorted(res.stale_baseline))


# ----------------------------------- backend-free families: both linters --

class _BothLinters:
    """Stands in for ``tests/test_lint.py``'s ``runner``: ``run`` lints
    with both packages and requires identical results; ``main`` is the
    port's CLI."""


    def run(self, root, paths=None, evidence_paths=None, select=None,
            baseline=None):
        ref = ref_runner.run(root, paths=paths,
                             evidence_paths=evidence_paths,
                             select=select, baseline=baseline)
        port = runner.run(root, paths=paths,
                          evidence_paths=evidence_paths,
                          select=select, baseline=baseline)
        assert keyed(port) == keyed(ref)
        return port

    main = staticmethod(runner.main)


BACKEND_FREE = [
    "test_ctl110_blocking_call_in_callback_context",
    "test_ctl110_done_callbacks_and_result_wait",
    "test_ctl110_callback_blocks_in_another_module",
    "test_ctl120_per_shard_blocking_recovery_loop",
    "test_ctl120_scope_and_noqa",
    "test_ctl120_per_shard_send_via_helper",
    "test_ctl120_recovery_named_helper_without_own_loop",
    "test_ctl130_copy_patterns_in_msg",
    "test_ctl130_objecter_fanout_and_helper_and_noqa",
    "test_ctl131_reply_rescan_and_chokepoint",
    "test_ctl131_reaches_helper_scope_and_noqa",
    "test_ctl301_cross_module_lock_order_inversion",
    "test_ctl302_raw_lock_scope_and_exemptions",
    "test_ctl401_undeclared_config_key",
    "test_ctl402_perf_type_conflict_across_modules",
    "test_ctl403_read_never_written",
    "test_ctl501_dispatch_without_register",
    "test_ctl502_register_without_dispatch_tests_count",
    "test_ctl601_fire_without_declare",
    "test_ctl601_declare_anywhere_in_tree_counts",
    "test_ctl603_swallowed_ioerror_to_default",
    "test_ctl603_scoped_to_io_facing_dirs",
    "test_ctl603_noqa_suppresses",
    "test_ctl604_store_write_bypasses_blockdev",
    "test_ctl604_scoped_to_store_modules",
    "test_ctl604_noqa_suppresses",
    "test_ctl605_marker_before_completion",
    "test_ctl605_resolves_wrapper_through_program_graph",
    "test_ctl605_scoped_and_clean_without_submit",
    "test_ctl605_noqa_suppresses",
    "test_ctl701_raw_send_without_trace_context",
    "test_ctl701_negatives",
    "test_ctl701_noqa_suppresses",
    "test_ctl701_var_flow_and_wrapper",
    "test_ctl701_incrementally_built_dict_is_a_gap",
    "test_ctl702_set_on_rate_counter_all_receiver_shapes",
    "test_ctl702_listed_counter_without_inc_site",
    "test_ctl702_noqa_and_inc_only_tree_clean",
    "test_ctl801_sent_but_unhandled_and_dead_arm",
    "test_ctl801_test_exercise_counts_and_noqa",
    "test_ctl802_mutating_send_outside_chokepoint",
    "test_ctl802_replay_set_read_from_tree",
    "test_ctl803_sender_omits_required_key",
    "test_ctl803_any_arm_satisfied_is_clean",
    "test_ctl804_duplicate_declare_and_undeclared_arm",
    "test_ctl804_noqa_suppresses",
    "test_ctl901_full_index_read_on_request_path",
    "test_ctl901_reaches_through_helper_and_scope_and_noqa",
    "test_noqa_inline_suppression",
    "test_baseline_round_trip",
    "test_write_baseline_select_preserves_other_families",
    "test_registry_mirrors_plugin_contract",
    "test_cli_json_and_check_exit_codes",
    "test_syntax_error_is_a_finding",
    "test_check_fails_on_stale_baseline",
    "test_cli_rule_alias_filters_families",
    "test_cli_graph_dump",
    "test_cli_sarif_output",
]

# the rule families the port copies as they are, for --select
BACKEND_FREE_SELECT = ["CTL000", "CTL110", "CTL120", "CTL13", "CTL3",
                       "CTL4", "CTL5", "CTL601", "CTL603", "CTL604",
                       "CTL605", "CTL7", "CTL8", "CTL9"]


@pytest.mark.parametrize("name", BACKEND_FREE)
def test_backend_free_fixture_equals_reference(name, tmp_path, capsys,
                                               monkeypatch):
    fn = getattr(ref_tests, name)
    monkeypatch.setattr(ref_tests, "runner", _BothLinters())
    monkeypatch.setattr(ref_tests, "baseline_mod", baseline_mod)
    monkeypatch.setattr(ref_tests, "RuleRegistry", RuleRegistry)
    monkeypatch.setattr(ref_tests, "Finding", core.Finding)
    monkeypatch.setattr(ref_tests, "LintError", core.LintError)
    args = {"tmp_path": tmp_path, "capsys": capsys}
    fn(**{p: args[p] for p in inspect.signature(fn).parameters})


def test_every_backend_free_reference_test_is_twinned():
    """No test of a copied family in tests/test_lint.py goes unmirrored:
    every reference test is either run above against both linters or
    has a torch twin in this file."""
    twinned = set(BACKEND_FREE) | {
        n for n in globals() if n.startswith("test_")}
    ref_names = {n for n in dir(ref_tests) if n.startswith("test_")}
    torch_twins = {
        "test_ctl101_host_sync_in_jit_positive_and_negative":
            "test_ctl101_host_sync_on_device_path",
        "test_ctl102_tracer_branch_and_static_arg_exemption":
            "test_ctl102_tensor_branch_and_metadata_exemption",
        "test_ctl103_jit_per_call": "test_ctl103_build_per_call",
        "test_ctl201_implicit_dtype_scoped_to_ops_placement":
            "test_ctl201_implicit_dtype_scoped_to_ops_placement",
        "test_ctl202_unpinned_param_ingest_in_ops":
            "test_ctl202_unpinned_param_ingest_in_ops",
        "test_ctl602_fire_in_jit_reachable_code":
            "test_ctl602_fire_in_capture_region",
        "test_ctl602_fire_in_jit_cross_module":
            "test_ctl602_fire_in_capture_cross_module",
        "test_cross_module_jit_reachability_via_from_import":
            "test_cross_module_device_path_via_from_import",
        "test_cross_module_resolution_import_alias":
            "test_cross_module_resolution_import_alias",
        "test_self_method_resolution_is_class_precise":
            "test_self_method_resolution_is_class_precise",
        "test_ctl1001_unbound_axis_across_modules":
            "test_ctl1001_literal_peer_across_modules",
        "test_ctl1001_hardcoded_literal_and_noqa":
            "test_ctl1001_rank_list_group_and_noqa",
        "test_ctl1002_trace_time_mutation_positive_and_negative":
            "test_ctl1002_capture_time_mutation_positive_and_negative",
        "test_ctl1002_trace_time_counter_demonstrably_miscounts":
            "test_ctl1002_capture_time_counter_is_flagged",
        "test_ctl1003_per_device_sync_through_helper":
            "test_ctl1003_per_cell_sync_through_helper",
        "test_ctl1004_spec_arity_and_unknown_axis":
            "test_ctl1004_literal_split_in_a_leg",
        "test_ctl1005_unreduced_total_and_bad_ppermute":
            "test_ctl1005_unreduced_count_and_bad_p2p_list",
        "test_ctl1006_process_rank_in_traced_code":
            "test_ctl1006_collective_under_a_rank_branch",
        "test_misspelled_axis_in_real_data_plane_is_caught":
            "test_dropped_psum_in_real_mesh_step_is_caught",
        "test_ctl131_real_tree_reply_lane_is_scan_clean":
            "test_ctl131_real_tree_reply_lane_is_scan_clean",
        "test_ctl130_real_tree_hot_path_is_view_clean":
            "test_ctl130_real_tree_hot_path_is_view_clean",
        "test_full_tree_lint_wall_time_budget":
            "test_full_tree_lint_wall_time_budget",
        "test_check_static_smoke": "test_check_static_smoke",
        "test_tree_is_lint_clean": "test_tree_is_lint_clean",
    }
    for ref_name in sorted(ref_names):
        assert ref_name in BACKEND_FREE or \
            torch_twins.get(ref_name) in twinned, ref_name


def test_backend_free_families_equal_reference_on_the_reference_tree():
    """Both linters over ``ceph_tpu/`` + ``scripts/`` with the reference's
    evidence (``tests/``), the copied families selected: the same
    findings and the same noqa list."""
    kw = dict(paths=["ceph_tpu", "scripts"], evidence_paths=["tests"],
              select=BACKEND_FREE_SELECT)
    ref = ref_runner.run(str(REPO), **kw)
    port = runner.run(str(REPO), **kw)
    assert keyed(port) == keyed(ref)
    assert len(port.noqa) > 0


def test_rule_ids_are_the_references():
    ref_ids = set(ref_runner.RuleRegistry.instance().names())
    assert set(RuleRegistry.instance().names()) == ref_ids


# --------------------------------------- CTL1xx: the device path (torch) --

BUILD = """\
    _libs = {}

    def load(name):
        return _libs[name]
    """


def test_ctl101_host_sync_on_device_path(tmp_path):
    write(tmp_path, "ops/_build.py", BUILD)
    write(tmp_path, "ops/kern.py", """\
        import numpy as np
        import torch
        from . import _build

        def _lib():
            return _build.load("kern")

        def helper(y: torch.Tensor):
            return float(y.sum())                 # on the path via launch

        def launch(x: torch.Tensor):
            out = torch.empty_like(x)
            _lib().ceph_kern(x.data_ptr(), out.data_ptr())
            torch.cuda.synchronize()
            host = np.asarray(out)
            return helper(out) + out.max().item() + host.size

        def host_only(x):
            return np.asarray(x.cpu()).item()     # not on the device path
        """)
    res = lint(tmp_path, select=["CTL101"])
    got = [(f.line, f.msg.split(" inside")[0]) for f in res.findings]
    assert got == [(9, "float() of a tensor"),
                   (14, "torch.cuda.synchronize()"),
                   (15, "host numpy call numpy.asarray() on a tensor"),
                   (16, ".item()")], res.findings
    assert all("device-path" in f.msg for f in res.findings)


def test_ctl101_one_line_reports_once(tmp_path):
    write(tmp_path, "ops/_build.py", BUILD)
    write(tmp_path, "ops/kern.py", """\
        from . import _build

        def launch(x, out):
            _build.load("k").ceph_k(x.data_ptr(), out.data_ptr())
            return out.cpu().numpy()
        """)
    res = lint(tmp_path, select=["CTL101"])
    assert [(f.line, f.msg.split(" inside")[0]) for f in res.findings] \
        == [(5, ".cpu(), .numpy()")]


def test_ctl101_twin_roots_join_the_device_path(tmp_path):
    """A DEVICE_ROOTS twin is a root with no kernel call of its own."""
    write(tmp_path, "ceph_tpu_torch/__init__.py", "")
    write(tmp_path, "ceph_tpu_torch/ops/__init__.py", "")
    write(tmp_path, "ceph_tpu_torch/ops/gf_jax.py", """\
        def bitplane_matmul(bitmat, data):
            return data.sum().item()

        def elsewhere(data):
            return data.sum().item()
        """)
    res = lint(tmp_path, select=["CTL101"])
    assert [(f.path, f.line) for f in res.findings] == \
        [("ceph_tpu_torch/ops/gf_jax.py", 2)]


def test_ctl102_tensor_branch_and_metadata_exemption(tmp_path):
    write(tmp_path, "ops/_build.py", BUILD)
    write(tmp_path, "ops/kern.py", """\
        import torch
        from . import _build

        def _lib():
            return _build.load("k")

        def launch(x: torch.Tensor, n: int):
            _lib().ceph_k(x.data_ptr())
            if x.any():                   # a tensor's value
                return x
            while (x > 0).sum():          # a tensor's value
                x = x - 1
            if n > 2:                     # a Python int: fine
                return x * n
            if x.numel() == 0:            # metadata: fine
                return x
            return -x

        def host(x: torch.Tensor):
            if x.any():                   # not on the device path
                return x
            return -x
        """)
    res = lint(tmp_path, select=["CTL102"])
    assert [f.line for f in res.findings] == [9, 11], res.findings
    assert "launch()" in res.findings[0].msg


def test_ctl103_build_per_call(tmp_path):
    write(tmp_path, "ops/_build.py", BUILD)
    write(tmp_path, "ops/kern.py", """\
        import ctypes
        import functools
        import torch
        from . import _build

        def per_call(x):
            return torch.compile(lambda v: v + 1)(x)   # fresh wrapper

        _hoisted = torch.compile(lambda v: v + 1)       # fine

        def cached(x):
            return _hoisted(x)

        @functools.lru_cache(maxsize=None)
        def _cached_lib():
            return ctypes.CDLL("libk.so")               # cached: fine

        def launch(x):
            _build.load("k").ceph_k(x.data_ptr())       # load + call
            lib = ctypes.CDLL("libk.so")                # per call
            return lib, _cached_lib()
        """)
    res = lint(tmp_path, select=["CTL103"])
    assert [f.line for f in res.findings] == [7, 19, 20], res.findings
    assert "one expression" in res.findings[0].msg
    assert "no cache" in res.findings[2].msg


def test_cross_module_device_path_via_from_import(tmp_path):
    """CTL101 whole-program: the host sync lives one module away from
    the kernel launcher, resolved through `from .x import f`."""
    write(tmp_path, "ops/_build.py", BUILD)
    write(tmp_path, "ops/helpers.py", """\
        def mix(y):
            return y.sum().item()          # on the path via ops.entry

        def cold(y):
            return y.sum().item()          # not reached
        """)
    write(tmp_path, "ops/entry.py", """\
        from . import _build
        from .helpers import mix

        def launch(x):
            _build.load("k").ceph_k(x.data_ptr())
            return mix(x)
        """)
    res = lint(tmp_path, select=["CTL101"])
    assert [(f.path, f.line) for f in res.findings] == \
        [("ops/helpers.py", 2)], res.findings


def test_cross_module_resolution_import_alias(tmp_path):
    """`from .b import helper as h` resolves across modules; an
    AMBIGUOUS obj.attr call falls back to the module-local name match
    (never cross-module)."""
    write(tmp_path, "ops/_build.py", BUILD)
    write(tmp_path, "ops/b.py", """\
        def helper(y):
            return y.tolist()
        """)
    write(tmp_path, "ops/a.py", """\
        from . import _build
        from .b import helper as h

        def launch(x):
            _build.load("k").ceph_k(x.data_ptr())
            return h(x)
        """)
    res = lint(tmp_path, select=["CTL101"])
    assert {f.path for f in res.findings} == {"ops/b.py"}
    write(tmp_path, "ops/a.py", """\
        from . import _build

        def launch(dt, x):
            _build.load("k").ceph_k(x.data_ptr())
            return dt.helper(x)
        """)
    res = lint(tmp_path, select=["CTL101"])
    assert not res.findings, res.findings


def test_self_method_resolution_is_class_precise(tmp_path):
    """`self._m()` resolves to the ENCLOSING class's method: a
    same-named method on a sibling class stays off the path."""
    write(tmp_path, "ops/_build.py", BUILD)
    write(tmp_path, "ops/mod.py", """\
        from . import _build

        class Hot:
            def run(self, x):
                _build.load("k").ceph_k(x.data_ptr())
                return self._m(x)

            def _m(self, x):
                return x.sum().item()       # on the path via run

        class Cold:
            def _m(self, x):
                return x.sum().item()       # must stay off the path
        """)
    res = lint(tmp_path, select=["CTL101"])
    assert sorted({f.line for f in res.findings}) == [9], res.findings


# -------------------------------------------------- CTL2xx: dtypes (torch) --

def test_ctl201_implicit_dtype_scoped_to_ops_placement(tmp_path):
    src = """\
        import torch
        BAD = torch.arange(8)
        ALSO_BAD = torch.zeros(4, 4)
        GOOD = torch.arange(8, dtype=torch.uint8)
        ALSO_GOOD = torch.full((4,), 7, dtype=torch.int32)
        LIKE_GOOD = torch.zeros_like(GOOD)      # inherits its dtype
        """
    write(tmp_path, "ops/gfx.py", src)
    write(tmp_path, "placement/mapx.py", src)
    write(tmp_path, "other/hostx.py", src)      # out of scope
    res = lint(tmp_path, select=["CTL201"])
    assert rules_of(res) == ["CTL201"] * 4
    assert {f.path for f in res.findings} == \
        {"ops/gfx.py", "placement/mapx.py"}
    assert sorted(f.line for f in res.findings) == [2, 2, 3, 3]
    assert "torch.arange()" in res.findings[0].msg


def test_ctl202_unpinned_param_ingest_in_ops(tmp_path):
    write(tmp_path, "ops/ing.py", """\
        import torch

        def encode(data):
            return torch.as_tensor(data)            # caller dtype leaks

        def encode_pinned(data):
            return torch.as_tensor(data, dtype=torch.uint8)

        def from_host(arr):
            return torch.from_numpy(arr)            # caller dtype leaks

        def from_host_pinned(arr):
            return torch.from_numpy(arr).to(torch.uint8)

        def local_ok():
            staged = [1, 2]
            return torch.tensor(staged)             # not a parameter
        """)
    res = lint(tmp_path, select=["CTL202"])
    assert rules_of(res) == ["CTL202", "CTL202"]
    assert [f.line for f in res.findings] == [4, 10]
    assert "from_numpy" in res.findings[1].msg


# ------------------------------------------ CTL602: fires in the capture set --

def test_ctl602_fire_in_capture_region(tmp_path):
    write(tmp_path, "pkg/kern.py", """\
        import torch
        from ceph_tpu_torch.common import faults

        faults.declare("kern.bad", "inside a captured region")
        faults.declare("kern.ok", "at the dispatch boundary")

        def helper(x):
            if faults.fire("kern.bad") is not None:   # captured
                return x
            return x + 1

        def capture(x, g):
            with torch.cuda.graph(g):
                y = helper(x)
                faults.fire("kern.bad")               # in the region
            return y

        def dispatch(x, g):
            if faults.fire("kern.ok") is not None:    # host side: fine
                return None
            return capture(x, g)
        """)
    res = lint(tmp_path, select=["CTL602"])
    assert [f.line for f in res.findings] == [8, 15], res.findings
    assert "graph-captured" in res.findings[0].msg


def test_ctl602_fire_in_capture_cross_module(tmp_path):
    write(tmp_path, "pkg/__init__.py", "")
    write(tmp_path, "pkg/inner.py", """\
        from ceph_tpu_torch.common import faults

        faults.declare("x.bad", "fired under a capture, one mod away")

        def helper(x):
            if faults.fire("x.bad") is not None:
                return x
            return x + 1
        """)
    write(tmp_path, "pkg/kern.py", """\
        import torch
        from .inner import helper

        def graphed(x):
            return helper(x)

        STEP = torch.cuda.make_graphed_callables(graphed, (None,))
        """)
    res = lint(tmp_path, select=["CTL602"])
    assert [(f.path, f.line) for f in res.findings] == \
        [("pkg/inner.py", 6)]


# ------------------------------------ CTL10xx: mesh legs and collectives --

MESH = """\
    def run_cells(mesh, fn):
        return {i: tuple(fn(i, c)) for i, c in enumerate(mesh)}

    def psum(mesh, partials, cells):
        return sum(partials[i] for i in cells)
    """


def test_ctl1001_literal_peer_across_modules(tmp_path):
    """The collective lives in a DIFFERENT module than the leg that
    reaches it, and takes a literal peer: one process runs it fine, a
    fleet of another size sends to the wrong rank."""
    write(tmp_path, "parallel/__init__.py", "")
    write(tmp_path, "parallel/mesh.py", MESH)
    write(tmp_path, "parallel/body.py", """\
        import torch.distributed as dist

        def shift(x, peer):
            ops = [dist.P2POp(dist.isend, x, 1),       # literal peer
                   dist.P2POp(dist.irecv, x, peer)]    # from the mesh
            return dist.batch_isend_irecv(ops)

        def never_in_a_leg(x):
            return dist.isend(x, 2)                    # not leg-reached
        """)
    write(tmp_path, "parallel/plane.py", """\
        from .body import shift
        from .mesh import run_cells

        def step(mesh, x):
            return run_cells(mesh, lambda i, c: (shift(x, c.rank),))
        """)
    res = lint(tmp_path, select=["CTL1001"])
    assert [(f.path, f.line) for f in res.findings] == \
        [("parallel/body.py", 4)], res.findings
    assert "hardcoded peer rank 1" in res.findings[0].msg
    assert "step()" in res.findings[0].msg


def test_ctl1001_rank_list_group_and_noqa(tmp_path):
    write(tmp_path, "parallel/__init__.py", "")
    write(tmp_path, "parallel/mesh.py", MESH + """\

    import torch.distributed as dist

    def row_group(ranks):
        return dist.new_group([0, 1])                  # mesh.py: fine
    """)
    write(tmp_path, "parallel/plane.py", """\
        import torch.distributed as dist
        from .mesh import row_group, run_cells

        PAIR = dist.new_group([0, 1])                  # literal ranks
        KEPT = dist.new_group(ranks=[2, 3])  # noqa: CTL1001 — fixture

        def leg(i, c, x):
            g = dist.new_group(ranks=list(range(4)))
            dist.all_reduce(x, group=g)                # built here
            dist.all_reduce(x, group=row_group(None))  # mesh's: fine
            return (x,)

        def step(mesh, x):
            return run_cells(mesh, lambda i, c: leg(i, c, x))
        """)
    res = lint(tmp_path, select=["CTL1001"])
    assert [(f.path, f.line) for f in res.findings] == \
        [("parallel/plane.py", 4), ("parallel/plane.py", 9)], \
        res.findings
    assert "hardcoded rank list [0, 1]" in res.findings[0].msg
    assert "group built outside" in res.findings[1].msg
    assert len(res.noqa) == 1


def test_ctl1002_capture_time_mutation_positive_and_negative(tmp_path):
    """Host-state mutation in code a CUDA graph captures: self attrs,
    captured dicts/lists, perf-counter .inc(), print().  Local
    containers and writes into tensors stay clean, as does the same
    code when nothing captures it."""
    write(tmp_path, "mod.py", """\
        import torch

        COUNTS = {}
        EVENTS = []

        class Plane:
            def step(self, x):
                self.calls = 1                # capture-time attr write
                COUNTS["step"] = 1            # captured dict write
                EVENTS.append(x)              # captured list append
                print("step")                 # capture-time print
                return x

            def cold(self, x):
                self.calls = 0                # never captured
                return x

        def f(x, pc, g, buf: torch.Tensor):
            with torch.cuda.graph(g):
                pc.inc("calls")               # counts the capture
                local = []
                local.append(x)               # local: fine
                buf[0] = 1.0                  # a tensor write: captured
                p = Plane()
                y = p.step(x)
            return y
        """)
    res = lint(tmp_path, select=["CTL1002"])
    lines = sorted(f.line for f in res.findings)
    assert lines == [8, 9, 10, 11, 20], res.findings
    msgs = " | ".join(f.msg for f in res.findings)
    assert "capture" in msgs
    assert ".inc()" in msgs and "print()" in msgs


def test_ctl1002_capture_time_counter_is_flagged(tmp_path):
    """The lie CTL1002 exists to catch: a host counter incremented in a
    captured callable counts the capture, not the replays (the card
    test ``test_torch_cuda.py::test_graph_replay_skips_host_counter``
    shows it at run time)."""
    write(tmp_path, "mod.py", """\
        import torch

        COUNTS = {"calls": 0}

        def step(x):
            COUNTS["calls"] += 1
            return x + 1

        GRAPHED = torch.cuda.make_graphed_callables(step, (None,))
        """)
    res = lint(tmp_path, select=["CTL1002"])
    assert rules_of(res) == ["CTL1002"], res.findings
    assert res.findings[0].line == 6
    assert "capture" in res.findings[0].msg


def test_ctl1003_per_cell_sync_through_helper(tmp_path):
    """Host syncs in a mesh leg — including across a module boundary —
    are per-cell round trips; shape-derived casts and host code no leg
    reaches stay clean."""
    write(tmp_path, "parallel/__init__.py", "")
    write(tmp_path, "parallel/mesh.py", MESH)
    write(tmp_path, "parallel/helper.py", """\
        def pull(x):
            return x.cpu()                    # reached from the leg

        def fine(x):
            return int(x.shape[0])            # static shape math

        def host_entry(x):
            return x.cpu()                    # never leg-reached
        """)
    write(tmp_path, "parallel/plane.py", """\
        import torch
        from .helper import fine, pull
        from .mesh import run_cells

        def step(mesh, x: torch.Tensor):
            def cell(i, c):
                n = int(x.sum())              # a tensor cast
                y = fine(x)
                return (pull(x), n + y)

            return run_cells(mesh, cell)
        """)
    res = lint(tmp_path, select=["CTL1003"])
    assert sorted((f.path, f.line) for f in res.findings) == \
        [("parallel/helper.py", 2), ("parallel/plane.py", 7)], \
        res.findings
    msgs = " | ".join(f.msg for f in res.findings)
    assert ".cpu()" in msgs and "int() of a tensor" in msgs
    assert "leg of the cell run at step()" in msgs


def test_ctl1004_literal_split_in_a_leg(tmp_path):
    write(tmp_path, "parallel/__init__.py", "")
    write(tmp_path, "parallel/mesh.py", MESH)
    write(tmp_path, "parallel/plane.py", """\
        import torch
        from .mesh import run_cells

        def bad(mesh, x):
            blocks = x.chunk(4)                        # literal count
            return run_cells(mesh, lambda i, c: (blocks[i],))

        def also_bad(mesh, x):
            def cell(i, c):
                return (torch.tensor_split(x, 8)[i],)  # literal count
            return run_cells(mesh, cell)

        def good(mesh, x):
            blocks = x.chunk(mesh.size)                # the cell count
            return run_cells(mesh, lambda i, c: (blocks[i],))

        def not_a_leg(x):
            return x.chunk(4)                          # no cell run
        """)
    res = lint(tmp_path, select=["CTL1004"])
    assert [f.line for f in res.findings] == [5, 10], res.findings
    assert "literal 4" in res.findings[0].msg
    assert "mesh's cell count" in res.findings[0].msg


def test_ctl1005_unreduced_count_and_bad_p2p_list(tmp_path):
    """A per-cell sum returned by a leg whose caller never sums over
    the cells reads one cell's partial as the cluster total; the
    psum'd twin is clean.  A literal P2POp list repeating a destination
    is flagged wherever it sits."""
    write(tmp_path, "parallel/__init__.py", "")
    write(tmp_path, "parallel/mesh.py", MESH)
    write(tmp_path, "parallel/plane.py", """\
        import torch.distributed as dist
        from .mesh import psum, run_cells

        def bad(mesh, x):
            def cell(i, c):
                return x, x.sum()
            outs = run_cells(mesh, cell)
            return outs[0][1]

        def good(mesh, x):
            def cell(i, c):
                return x, x.sum()
            outs = run_cells(mesh, cell)
            return psum(mesh, {i: o[1] for i, o in outs.items()},
                        range(len(outs)))

        def shifty(x):
            ops = [dist.P2POp(dist.isend, x, 1),
                   dist.P2POp(dist.isend, x, 1)]
            return dist.batch_isend_irecv(ops)
        """)
    res = lint(tmp_path, select=["CTL1005"])
    assert sorted((f.path, f.line) for f in res.findings) == \
        [("parallel/plane.py", 6), ("parallel/plane.py", 18)], \
        res.findings
    msgs = " | ".join(f.msg for f in res.findings)
    assert "cluster total" in msgs and "repeats a destination" in msgs


def test_ctl1006_collective_under_a_rank_branch(tmp_path):
    """A collective only some ranks reach (a branch on the rank,
    directly, through a local or through a helper) deadlocks the fleet;
    a branch on the collective's result is the blessed pattern, and a
    ``# noqa: CTL1006`` suppresses."""
    write(tmp_path, "parallel/__init__.py", "")
    write(tmp_path, "parallel/multihost.py", """\
        import torch.distributed as dist

        def process_index():
            return dist.get_rank()

        def all_reduce_sum(t):
            dist.all_reduce(t)
            return t
        """)
    write(tmp_path, "parallel/plane.py", """\
        import torch.distributed as dist
        from . import multihost

        def bad(x):
            if dist.get_rank() == 0:
                dist.all_reduce(x)
            return x

        def bad_helper(x):
            me = multihost.process_index()
            if me != 0:
                multihost.all_reduce_sum(x)
            return x

        def justified(x):
            if dist.get_rank() == 0:  # noqa: CTL1006 — one-rank test
                dist.barrier()
            return x

        def good(x):
            total = multihost.all_reduce_sum(x)
            if dist.get_rank() == 0:
                print(total)
            return total
        """)
    res = lint(tmp_path, select=["CTL1006"])
    assert [(f.path, f.line) for f in res.findings] == \
        [("parallel/plane.py", 5), ("parallel/plane.py", 11)], \
        res.findings
    assert "dist.all_reduce()" in res.findings[0].msg
    assert "all_reduce_sum()" in res.findings[1].msg
    assert "deadlocks" in res.findings[0].msg
    assert len(res.noqa) == 1


def test_dropped_psum_in_real_mesh_step_is_caught(tmp_path):
    """Acceptance: drop the psum from a copy of the REAL
    parallel/mesh.py's sharded step and `ceph lint` reports the per-cell
    byte count returned as the cluster total — the fault one process
    never shows."""
    real = (REPO / "ceph_tpu_torch" / "parallel" / "mesh.py").read_text()
    good = "    total = psum(mesh, {i: o[1] for i, o in outs.items()}, " \
        "replica)\n"
    assert good in real, "expected the psum of the sharded step"
    write(tmp_path, "parallel/mesh.py", real)
    assert not lint(tmp_path, select=["CTL1005"]).findings
    write(tmp_path, "parallel/mesh.py",
          real.replace(good, "    total = outs[0][1]\n"))
    res = lint(tmp_path, select=["CTL1005"])
    assert [f.path for f in res.findings] == ["parallel/mesh.py"]
    assert "cell()" in res.findings[0].msg and \
        "_step()" in res.findings[0].msg

    # and through the operator CLI
    from ceph_tpu_torch.tools.ceph_cli import main as ceph_main
    buf = io.StringIO()
    rc = ceph_main(["lint", ".", "--root", str(tmp_path), "--select",
                    "CTL1005", "--baseline", "none", "--check"], out=buf)
    assert rc == 1
    assert "cluster total" in buf.getvalue()


# ------------------------------------------------ the device-path roots --

def _ref_program():
    mods = {}
    for rel in ("ceph_tpu",):
        for full, relpath in ref_runner._iter_py(str(REPO), rel):
            m, err = ref_parse(full, relpath)
            if m is not None:
                mods[relpath] = m
    program = RefProgram(mods)
    for m in mods.values():
        m.program = program
    return program


def test_device_roots_cover_the_references_jit_roots(tree_lint):
    """Every function the reference marks jit-direct in ``ceph_tpu/``
    has its twin listed in DEVICE_ROOTS; every function whose twin
    module and name exist in the port is a root of the port's
    device-path set; and no listed root name goes stale."""
    ref_prog = _ref_program()
    rg = ref_astutil.program_graph(ref_prog)
    ref_direct = {rg.qualname(fn)
                  for fn in ref_astutil._program_hot(ref_prog).direct}
    listed = dict(astutil.DEVICE_ROOTS)
    # the one jit root without a twin (the port evaluates the exact
    # log table, never the f32 approximation)
    untwinned = {"ceph_tpu.placement.fast_mapper._approx_numer_f32"}
    assert ref_direct - untwinned == set(listed), \
        sorted(ref_direct ^ set(listed))

    program = tree_lint["result"].program
    g = astutil.program_graph(program)
    hot = astutil._program_hot(program)
    roots = {g.qualname(fn) for fn in hot.direct}
    names = {g.qualname(fn) for fn in g.mod_of}
    for port in listed.values():
        assert port in names, f"stale device root {port}"
        assert port in roots, port
    for ref in ref_direct:
        twin = ref.replace("ceph_tpu.", "ceph_tpu_torch.", 1)
        if twin in names:
            assert twin in roots, twin


def test_device_path_set_is_bounded(tree_lint):
    """The device-path set stays the kernels' host side: its size is
    bounded, no daemon-plane module joins it, and the kernel wrappers'
    launches are its roots."""
    program = tree_lint["result"].program
    g = astutil.program_graph(program)
    hot = astutil._program_hot(program)
    assert 100 <= len(hot.hot) <= 220, len(hot.hot)
    assert 20 <= len(hot.direct) <= 40, len(hot.direct)
    mods = {g.mod_of[fn].relpath for fn in hot.hot}
    for forbidden in ("cluster/daemon.py", "client/remote.py",
                      "msg/wire.py", "cluster/simulator.py"):
        assert not any(m.endswith(forbidden) for m in mods), forbidden
    kinds = {g.qualname(fn): why for fn, why in hot.direct.items()}
    assert kinds["ceph_tpu_torch.ops.gf_pallas._launch_fused"] == "kernel"
    assert kinds["ceph_tpu_torch.ops.xor_kernel.matmul_floor"] == "kernel"
    assert kinds["ceph_tpu_torch.placement.fast_mapper.FastMapper"
                 ".map_batch"] == "dispatch"
    assert astutil.capture_set(program).fns == set()


# ------------------------------------------- the gate on the port's tree --

@pytest.fixture(scope="module")
def tree_lint():
    """ONE whole-tree run of the port's lint, shared by the gate, the
    wall-time budget and the check_static real tier."""
    t0 = time.perf_counter()
    res = runner.run(str(REPO), baseline=str(REPO / runner.DEFAULT_BASELINE))
    return {"result": res, "elapsed": time.perf_counter() - t0}


def test_tree_is_lint_clean(tree_lint):
    """`python -m ceph_tpu_torch.tools.lint --check` equivalent: a new
    violation anywhere in the port fails the suite.  The baseline is
    capped at the reference's 10 entries."""
    res = tree_lint["result"]
    assert not res.findings, "new lint findings:\n" + \
        "\n".join(f.render() for f in res.findings)
    assert len(res.baselined) <= 10, \
        "baseline grew past the 10-entry budget — fix, don't hide"
    assert not res.stale_baseline, \
        f"stale baseline entries: {res.stale_baseline}"
    # the deliberate exceptions are inline, each with its reason
    assert {f.rule for f in res.noqa} >= {"CTL101", "CTL102", "CTL202"}


def test_full_tree_lint_wall_time_budget(tree_lint):
    assert tree_lint["result"].program is not None
    assert tree_lint["elapsed"] < 30.0, \
        f"full-tree lint took {tree_lint['elapsed']:.1f}s — past the " \
        f"CI budget"


def test_check_static_smoke(tree_lint, capsys):
    """tools/check_static end to end: every seeded violation caught,
    and the real tier clean inside the budget (on the shared run)."""
    from ceph_tpu_torch.tools import check_static
    assert check_static.main(["--quick"]) == 0
    assert check_static.real_tree(tree_lint["result"],
                                  tree_lint["elapsed"]) == 0
    out = capsys.readouterr().out
    assert "all 11 seeded violations caught" in out
    assert "real tier — tree clean" in out


def test_lint_cli_check_exit_code(tmp_path):
    """`python -m ceph_tpu_torch.tools.lint --check` on a tree: 1 with a
    finding, 0 once it is gone."""
    from ceph_tpu_torch.tools import lint as lint_tool
    write(tmp_path, "cluster/svc.py",
          "import threading\nL = threading.Lock()\n")
    out = io.StringIO()
    assert lint_tool.main(["--root", str(tmp_path), "--check",
                           "--baseline", "none", "."], out=out) == 1
    write(tmp_path, "cluster/svc.py", "X = 1\n")
    out = io.StringIO()
    assert lint_tool.main(["--root", str(tmp_path), "--check", "--json",
                           "--baseline", "none", "."], out=out) == 0
    assert json.loads(out.getvalue())["count"] == 0


def test_ctl131_real_tree_reply_lane_is_scan_clean(monkeypatch):
    """The reply lane: zero un-noqa'd rescans in msg/ + cluster/.  The
    one rescan the rule sees is the receive verify's counted host pass
    in msg/wire.py, which carries the reference's ``# noqa: CTL131``
    (CTL131 drops a suppressed site itself, so it is shown here with
    suppression switched off)."""
    kw = dict(paths=["ceph_tpu_torch/msg", "ceph_tpu_torch/cluster"],
              select=["CTL131"])
    res = runner.run(str(REPO), **kw)
    assert not res.findings, "\n".join(
        f.render() for f in res.findings)
    monkeypatch.setattr(core.ParsedModule, "suppressed",
                        lambda self, line, rule: False)
    res = runner.run(str(REPO), **kw)
    assert [(f.path, "receive_csums" in f.msg) for f in res.findings] \
        == [("ceph_tpu_torch/msg/wire.py", True)]
    line = (REPO / res.findings[0].path).read_text().splitlines()[
        res.findings[0].line - 1]
    assert "# noqa: CTL131" in line


def test_ctl130_real_tree_hot_path_is_view_clean():
    res = runner.run(str(REPO),
                     paths=["ceph_tpu_torch/msg", "ceph_tpu_torch/cluster",
                            "ceph_tpu_torch/client"],
                     select=["CTL130"])
    assert not res.findings, "\n".join(
        f.render() for f in res.findings)


def test_standalone_module_gets_its_own_program(tmp_path):
    """A module parsed outside a run still answers the device-path
    question (the reference's module-local fallback)."""
    p = write(tmp_path, "ops/k.py", """\
        def launch(lib, x):
            return x
        """)
    mod, err = core.parse_module(str(p), "ops/k.py")
    assert err is None
    assert astutil.hot_functions(mod).hot == set()
    assert mod.program is not None
