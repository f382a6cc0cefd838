"""A faithful in-process fake of the Ray API for the port's trainer
and serving tests: actor methods run synchronously in-process at
``.remote`` time, their exceptions held until ``ray.get`` (where real Ray
surfaces a task error), and a worker returning the sentinel ``"HANG"``
stays pending in ``ray.wait``, a rank stuck in a dead collective. The
same fake as ``tests/test_rayint_cluster.py`` drives the JAX trainer
with.
"""

import types



class _Future:
    """Executes eagerly (at .remote time, like the old fake) but holds
    exceptions until .value — real Ray surfaces task errors at ray.get,
    and the trainer's per-rank error attribution lives there."""

    def __init__(self, value=None, error=None):
        self._v = value
        self._err = error

    @property
    def value(self):
        if self._err is not None:
            raise self._err
        return self._v


class _ActorMethod:
    def __init__(self, bound):
        self._bound = bound

    def remote(self, *a, **k):
        try:
            return _Future(self._bound(*a, **k))
        except Exception as e:  # noqa: BLE001 - delivered at ray.get
            return _Future(error=e)


class _ActorHandle:
    def __init__(self, cls, opts):
        self._inst = cls()
        self._opts = opts

    def __getattr__(self, name):
        return _ActorMethod(getattr(self._inst, name))


class _PlacementGroup:
    def __init__(self, bundles, strategy):
        self.bundles = bundles
        self.strategy = strategy

    def ready(self):
        return _Future(True)


def make_fake_ray(record):
    ray = types.ModuleType("ray")
    ray_util = types.ModuleType("ray.util")
    sched_mod = types.ModuleType("ray.util.scheduling_strategies")

    class PlacementGroupSchedulingStrategy:
        def __init__(self, placement_group=None,
                     placement_group_bundle_index=None):
            record["sched_bundles"].append(placement_group_bundle_index)

    sched_mod.PlacementGroupSchedulingStrategy = \
        PlacementGroupSchedulingStrategy

    def remote(*dargs, **dkw):
        def wrap(cls):
            class Remote:
                @staticmethod
                def options(**opts):
                    class Factory:
                        @staticmethod
                        def remote():
                            record["actor_opts"].append(opts)
                            handle = _ActorHandle(cls, opts)
                            record.setdefault("actors", []).append(
                                handle._inst)
                            return handle
                    return Factory
            return Remote
        if dargs and callable(dargs[0]):
            return wrap(dargs[0])
        return wrap

    def placement_group(bundles, strategy="PACK"):
        pg = _PlacementGroup(bundles, strategy)
        record["placement_groups"].append(pg)
        return pg

    ray.remote = remote
    ray.is_initialized = lambda: True
    ray.init = lambda *a, **k: None
    ray.get = lambda f: ([x.value for x in f] if isinstance(f, list)
                         else f.value)

    def wait(futures, num_returns=None, timeout=None):
        # the sync fake cannot truly hang; workers returning the
        # sentinel "HANG" model one stuck in a dead collective (the
        # trainer's worker wrapper ships it inside the result payload).
        # Errored futures count as done (real ray.wait returns them as
        # ready; the error is delivered at ray.get)
        def hanging(f):
            v = f._v
            return f._err is None and (
                v == "HANG" or (isinstance(v, dict)
                                and v.get("metrics") == "HANG"))
        done = [f for f in futures if not hanging(f)]
        pending = [f for f in futures if hanging(f)]
        return done, pending

    ray.wait = wait
    ray.kill = lambda actor: record["killed"].append(actor)
    ray_util.get_node_ip_address = lambda: "10.0.0.1"
    ray_util.placement_group = placement_group
    ray_util.remove_placement_group = \
        lambda pg: record["removed_pgs"].append(pg)
    ray.util = ray_util
    return ray, {"ray.util": ray_util,
                 "ray.util.scheduling_strategies": sched_mod}


def install(monkeypatch, *modules):
    """Put the fake in place of ``ray`` in each of ``modules`` (their
    ``ray`` and ``_HAS_RAY``) and in ``sys.modules``; returns the record
    of what the code under test asked of it."""
    import sys
    record = {"actor_opts": [], "placement_groups": [], "actors": [],
              "sched_bundles": [], "removed_pgs": [], "killed": []}
    ray, mods = make_fake_ray(record)
    for mod in modules:
        monkeypatch.setattr(mod, "ray", ray)
        monkeypatch.setattr(mod, "_HAS_RAY", True)
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setitem(sys.modules, "ray", ray)
    return record
