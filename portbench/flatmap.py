"""The flat CRUSH map the configurations state: a straw2 root over
``hosts`` straw2 host buckets of ``osds_per_host`` OSDs each, built
through the port's own builder, with the configuration's one rule."""
from __future__ import annotations

RULES = {"TAKE root / CHOOSELEAF_FIRSTN 0 host / EMIT": "firstn",
         "TAKE root / CHOOSELEAF_INDEP 0 host / EMIT": "indep"}


def build(cfg):
    """(the port's CrushMap with the rule as rule 0, [OSDs of host h])."""
    from ceph_tpu_torch.placement.builder import TYPE_HOST, \
        build_flat_cluster
    from ceph_tpu_torch.placement.crush_map import (
        RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP, RULE_EMIT,
        RULE_TAKE, Rule)
    if cfg["bucket_alg"] != "straw2":
        raise ValueError(f"bucket_alg {cfg['bucket_alg']!r}: the flat "
                         f"builder makes straw2 buckets only")
    if cfg["rule"] not in RULES:
        raise ValueError(f"rule {cfg['rule']!r}: one of {list(RULES)}")
    cmap, root = build_flat_cluster(n_hosts=cfg["hosts"],
                                    osds_per_host=cfg["osds_per_host"])
    op = RULE_CHOOSELEAF_FIRSTN if RULES[cfg["rule"]] == "firstn" \
        else RULE_CHOOSELEAF_INDEP
    cmap.add_rule(Rule(steps=[(RULE_TAKE, root, 0), (op, 0, TYPE_HOST),
                              (RULE_EMIT, 0, 0)]))
    per = cfg["osds_per_host"]
    hosts = [list(range(h * per, (h + 1) * per))
             for h in range(cfg["hosts"])]
    for h, osds in enumerate(hosts):
        if cmap.bucket(-1 - h).items != osds:
            raise ValueError(f"host {h} is not bucket {-1 - h} of OSDs "
                             f"{osds[0]}..{osds[-1]}")
    return cmap, hosts
