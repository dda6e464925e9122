"""The powercycle soak's schedule as a function of its seed and kill
windows.

``PowerCycleThrasher`` (cluster/thrasher.py) draws every choice of its
soak from one seeded rng, but a kill window ends when the victim is seen
dead, which is timing.  The model here gives the schedule the seed makes
for given windows; the soak tests on the CPU (test_torch_thrasher.py)
and on the card (test_torch_cuda.py) hold each schedule to it; the
file imports no JAX, so the card's tests can use it.
"""
import random

PC_CFG = dict(seed=0, cycles=2, n_osds=3, objects=4, writes_per_cycle=2,
              kill_writes=10)


def seeded_schedule(windows, seed=0, cycles=2, n_osds=3, objects=4,
                    writes_per_cycle=2, kill_writes=10, object_size=3072):
    """The powercycle schedule the seed makes when cycle ``c``'s kill
    window holds ``windows[c]`` writes.  The window ends when the victim
    is seen dead, which is timing (a loaded host sees it a write or more
    later, or not at all and the SIGKILL fallback ends it), and every
    write of the window draws its payload from the run's rng, so the
    rest of the schedule follows from the seed and the windows."""
    rng = random.Random(seed)

    def blob():
        return bytes(rng.getrandbits(8) for _ in range(object_size))
    out = []
    for j in range(objects):
        blob()
        out.append(["write", 1, f"pcobj-{j}"])
    for cycle in range(cycles):
        out.append(["cycle", cycle])
        for _ in range(writes_per_cycle):
            name = f"pcobj-{rng.randrange(objects)}"
            blob()
            out.append(["write", 1, name])
        victim = rng.randrange(n_osds)
        point = ("device.power_loss" if rng.random() < 0.5
                 else "device.torn_write")
        out.append(["powercycle", cycle, victim, point,
                    2 + rng.randrange(3)])
        for i in range(windows[cycle]):
            blob()
            out.append(["kill_write", 1, f"pc-{cycle}-{i}"])
        rng.randrange(1, 64)                 # tear_wal_tail's one draw
        out.append(["wal_tear", cycle, victim])
    return out


def kill_windows(schedule, cycles=2):
    return [sum(1 for e in schedule if e[0] == "kill_write" and
                e[2].startswith(f"pc-{c}-")) for c in range(cycles)]


def test_seeded_schedule_model_is_the_reference_soaks():
    """The model gives the schedule both packages printed for seed 0 on
    an unloaded host: victims 2 then 1, a power loss then a torn write,
    two kill writes then one."""
    sched = seeded_schedule([2, 1])
    assert [e[0] for e in sched].count("kill_write") == 3
    assert sched[7] == ["powercycle", 0, 2, "device.power_loss", 2]
    assert sched[14] == ["powercycle", 1, 1, "device.torn_write", 2]
