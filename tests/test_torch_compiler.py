"""The port's crushmap text compiler against ceph_tpu's.

The same crushmap texts go through ``compile_crushmap`` of both packages;
the maps they give must carry the same state (``convert.crush_map_state``:
buckets with their derived straws, prefix sums and tree nodes, rules,
names, device classes with their shadow buckets, and ``choose_args``), and
``decompile_crushmap`` must print the same text.  A compiled legacy map
then maps through the port's ``XlaMapper`` equal to the reference's
scalar mapper.  Mirrors tests/test_compiler.py.
"""
import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu.placement import compiler as ref_compiler
from ceph_tpu.placement import scalar_mapper as ref_scalar
from ceph_tpu.placement.crush_map import ITEM_NONE, WEIGHT_ONE
from ceph_tpu_torch import convert
from ceph_tpu_torch.placement import compiler as port_compiler
from ceph_tpu_torch.placement import xla_mapper as port_xla
from ceph_tpu_torch.placement.crush_map import CrushMap as PortCrushMap

# One intra-op thread per test process: the suite runs under several
# xdist workers, and a full torch pool in each oversubscribes the
# cores and starves the tests that run beside them.
torch.set_num_threads(1)

BASIC = """
# minimal but realistic map
tunable choose_total_tries 50
tunable chooseleaf_stable 1

device 0 osd.0
device 1 osd.1
device 2 osd.2
device 3 osd.3

type 0 osd
type 1 host
type 10 root

host node-a {
    id -1
    alg straw2
    hash 0
    item osd.0 weight 1.00000
    item osd.1 weight 1.00000
}
host node-b {
    id -2
    alg straw2
    hash 0
    item osd.2 weight 1.00000
    item osd.3 weight 2.00000
}
root default {
    id -3
    alg straw2
    hash 0
    item node-a weight 2.00000
    item node-b weight 3.00000
}

rule replicated_rule {
    id 0
    type replicated
    min_size 1
    max_size 10
    step take default
    step chooseleaf firstn 0 type host
    step emit
}
"""

CLASSES = """
device 0 osd.0 class hdd
device 1 osd.1 class ssd
device 2 osd.2 class hdd
device 3 osd.3 class ssd
type 0 osd
type 1 host
type 10 root
host h1 {
    id -1
    id -11 class hdd
    id -21 class ssd
    alg straw2
    hash 0
    item osd.0 weight 1.00000
    item osd.1 weight 1.00000
}
host h2 {
    id -2
    id -12 class hdd
    id -22 class ssd
    alg straw2
    hash 0
    item osd.2 weight 1.00000
    item osd.3 weight 1.00000
}
root default {
    id -3
    id -13 class hdd
    id -23 class ssd
    alg straw2
    hash 0
    item h1 weight 2.00000
    item h2 weight 2.00000
}
rule ssd_rule {
    id 0
    type replicated
    min_size 1
    max_size 10
    step take default class ssd
    step chooseleaf firstn 0 type host
    step emit
}
"""

CHOOSE_ARGS = BASIC + """
choose_args 0 {
  {
    bucket_id -3
    weight_set [
      [ 1.00000 2.00000 ]
      [ 2.00000 1.00000 ]
    ]
  }
}
"""

SET_STEPS = """
device 0 osd.0
device 1 osd.1
device 2 osd.2
type 0 osd
type 10 root
root default {
    id -1
    alg straw2
    hash 0
    item osd.0 weight 1.00000
    item osd.1 weight 1.00000
    item osd.2 weight 1.00000
}
rule ec_rule {
    id 1
    type erasure
    min_size 3
    max_size 6
    step set_chooseleaf_tries 5
    step set_choose_tries 100
    step take default
    step choose indep 0 type osd
    step emit
}
"""

ITEM_POS = """
device 0 osd.0
device 1 osd.1
type 0 osd
type 1 host
host h {
    id -1
    alg straw2
    hash 0
    item osd.1 weight 1.00000 pos 1
    item osd.0 weight 1.00000 pos 0
}
"""

DEFAULT_WEIGHTS = BASIC.replace("item node-a weight 2.00000", "item node-a") \
    .replace("item node-b weight 3.00000", "item node-b")


def legacy_text(alg_hosts=("uniform", "list", "tree", "straw"),
                root_alg="straw", osds_per_host=4):
    """A root of ``root_alg`` over one host per algorithm, hammer
    tunables and straw_calc_version 1 (a cluster made before straw2)."""
    rng = np.random.default_rng(5)
    lines = ["tunable choose_local_tries 0",
             "tunable choose_local_fallback_tries 0",
             "tunable choose_total_tries 50",
             "tunable chooseleaf_descend_once 1",
             "tunable chooseleaf_vary_r 1",
             "tunable chooseleaf_stable 0",
             "tunable straw_calc_version 1", ""]
    n = len(alg_hosts) * osds_per_host
    lines += [f"device {i} osd.{i}" for i in range(n)]
    lines += ["", "type 0 osd", "type 1 host", "type 3 rack",
              "type 10 root", ""]
    for h, alg in enumerate(alg_hosts):
        lines += [f"host host-{h} {{", f"    id -{h + 1}", f"    alg {alg}",
                  "    hash 0"]
        for i in range(h * osds_per_host, (h + 1) * osds_per_host):
            w = 1.0 if alg == "uniform" else 0.5 + 1.5 * rng.random()
            lines.append(f"    item osd.{i} weight {w:.5f}")
        lines.append("}")
    lines += ["root default {", f"    id -{len(alg_hosts) + 1}",
              f"    alg {root_alg}", "    hash 0"]
    lines += [f"    item host-{h}" for h in range(len(alg_hosts))]
    lines += ["}", "",
              "rule rep {", "    id 0", "    type replicated",
              "    step take default", "    step chooseleaf firstn 0 type host",
              "    step emit", "}",
              "rule ec {", "    id 1", "    type erasure",
              "    step take default", "    step choose indep 2 type host",
              "    step chooseleaf indep 2 type osd", "    step emit", "}"]
    return "\n".join(lines) + "\n"


TEXTS = {"basic": BASIC, "classes": CLASSES, "choose_args": CHOOSE_ARGS,
         "set_steps": SET_STEPS, "item_pos": ITEM_POS,
         "default_weights": DEFAULT_WEIGHTS, "legacy": legacy_text(),
         "cli_basic": open("tests/cli/basic.crush").read(),
         "cli_classes": open("tests/cli/classes.crush").read()}


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = ceph_tpu_torch.default_device()
    ceph_tpu_torch.set_default_device("cpu")
    yield
    ceph_tpu_torch.set_default_device(prev)


def assert_same_state(a, b):
    sa, sb = convert.crush_map_state(a), convert.crush_map_state(b)
    assert sa.keys() == sb.keys()
    for key in sa:
        if key not in ("buckets", "choose_args"):
            assert sa[key] == sb[key], key
    assert len(sa["buckets"]) == len(sb["buckets"])
    for x, y in zip(sa["buckets"], sb["buckets"]):
        assert (x is None) == (y is None)
        if x is None:
            continue
        for f in x:
            assert (x[f] is None and y[f] is None) or \
                np.array_equal(x[f], y[f]), f
    assert sa["choose_args"].keys() == sb["choose_args"].keys()
    for k in sa["choose_args"]:
        for x, y in zip(sa["choose_args"][k], sb["choose_args"][k]):
            assert (x is None) == (y is None)
            if x is not None:
                for f in ("ids", "weight_set"):
                    assert (x[f] is None and y[f] is None) or \
                        np.array_equal(x[f], y[f]), f


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_compile_and_decompile_equal_reference(name):
    text = TEXTS[name]
    ref = ref_compiler.compile_crushmap(text)
    port = port_compiler.compile_crushmap(text)
    assert isinstance(port, PortCrushMap)
    assert_same_state(port, ref)
    assert port.to_spec() == ref.to_spec()
    dec = port_compiler.decompile_crushmap(port)
    assert dec == ref_compiler.decompile_crushmap(ref)
    # the decompiled text is a fixed point of both compilers
    again = port_compiler.compile_crushmap(dec)
    assert port_compiler.decompile_crushmap(again) == dec
    # and a carried reference map decompiles to the same text
    assert port_compiler.decompile_crushmap(
        convert.crush_map_from_state(convert.crush_map_state(ref))) == dec


def test_shadow_buckets_and_class_take():
    port = port_compiler.compile_crushmap(CLASSES)
    assert port.class_bucket_ids[(-3, "ssd")] == -23
    assert port.bucket(-21).items == [1] and port.bucket(-22).items == [3]
    assert port.rules[0].steps[0][1] == -23
    assert "step take default class ssd" in \
        port_compiler.decompile_crushmap(port)


@pytest.mark.parametrize("bad", [
    "bogus directive",
    "tunable not_a_tunable 1",
    "type 1 host\nhost h { id -1 alg nosuchalg hash 0 }\n",
    "type 1 host\nhost h { id -1 alg straw2 hash 0 item osd.9 weight 1.0 }\n",
    "type 1 host\nhost h { id -1 alg straw2 hash 0\n",
])
def test_errors_equal_reference(bad):
    with pytest.raises(ref_compiler.CompileError) as ref_err:
        ref_compiler.compile_crushmap(bad)
    with pytest.raises(port_compiler.CompileError) as port_err:
        port_compiler.compile_crushmap(bad)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("ruleno,result_max", [(0, 3), (1, 4)])
def test_compiled_legacy_map_maps_equal_to_scalar(ruleno, result_max):
    """Every legacy algorithm under a straw root, compiled from text, maps
    through the port's dispatch (the fast mapper refuses it, the general
    trace carries it) equal to the reference's scalar mapper."""
    text = legacy_text()
    ref = ref_compiler.compile_crushmap(text)
    port = port_compiler.compile_crushmap(text)
    weights = [WEIGHT_ONE] * ref.max_devices
    weights[3] = 0
    xs = np.arange(96)
    got = port_xla.XlaMapper(port).map_batch(ruleno, xs, result_max, weights)
    want = np.full((len(xs), result_max), ITEM_NONE, dtype=np.int32)
    for i, x in enumerate(xs):
        row = ref_scalar.do_rule(ref, ruleno, int(x), result_max, weights)
        want[i, :len(row)] = row
    assert np.array_equal(got, want)
