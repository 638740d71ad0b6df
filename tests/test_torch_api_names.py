"""The port's public names against the reference's, on the CPU.

For ``repro.sim``, ``repro.cluster``, ``repro.core`` and
``repro.workloads`` (and, at the end, ``repro.models``, its ``moe``,
``whisper``, ``frontends`` and ``rope`` modules and
``repro.launch.serve``, and the training modules ``repro.optim``,
``repro.data``, ``repro.checkpoint``, ``repro.launch.train`` and
``repro.launch.steps``, and the sharding modules
``repro.models.sharding``, ``repro.models.partitioning``,
``repro.launch.specs``, ``repro.launch.mesh`` and the ``repro.launch``
package): every public name of the reference exists in the port unless
it belongs to a slice still to come (``PENDING``, each with
its ROADMAP id, so that a slice that lands shrinks the list); a
function keeps the reference's positional parameters, the port adding
at most a trailing ``device``; a class keeps the reference's public
attributes (methods, class methods, properties), and so does each
policy registry.  The reference is reached through a fixture, so the
file also collects where JAX is absent.
"""
import importlib
import importlib.util
import inspect

import pytest

#: Public names of the reference that the port does not have yet, with
#: the ROADMAP item that ports them.
PENDING = {
    "cluster": {},
    "core": {},
    "sim": {},
    "workloads": {},
}
PACKAGES = tuple(PENDING)


@pytest.fixture(scope="module", autouse=True)
def _reference_imported():
    """Import the reference's packages before the first test, where JAX
    is present.  Some register policies when first imported, and
    ``conftest``'s per-test rollback of the registries would drop those
    registered inside a test for every later test of the process."""
    if importlib.util.find_spec("jax") is not None:
        for name in PACKAGES:
            importlib.import_module(f"repro.{name}")


def modules(name):
    pytest.importorskip("jax")
    return (importlib.import_module(f"repro.{name}"),
            importlib.import_module(f"repro_torch.{name}"))


def public(mod) -> set:
    return set(getattr(mod, "__all__", None)
               or (n for n in dir(mod) if not n.startswith("_")))


def positional(fn) -> list:
    kinds = (inspect.Parameter.POSITIONAL_ONLY,
             inspect.Parameter.POSITIONAL_OR_KEYWORD)
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in kinds]


def members(cls) -> set:
    return {k for c in cls.__mro__ if c is not object
            for k in vars(c) if not k.startswith("_")}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_public_names_are_ported(pkg):
    ref, port = modules(pkg)
    pending = set(PENDING[pkg])
    missing = sorted(public(ref) - public(port) - pending)
    assert not missing, f"repro_torch.{pkg} lacks {missing}"
    # a pending name that has landed leaves the list
    landed = sorted(pending & public(port))
    assert not landed, f"repro_torch.{pkg} has {landed}: drop them " \
        "from PENDING"
    assert pending <= public(ref)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_functions_keep_their_positional_parameters(pkg):
    ref, port = modules(pkg)
    for name in sorted(public(ref) & public(port)):
        a, b = getattr(ref, name), getattr(port, name)
        if not (inspect.isfunction(a) and inspect.isfunction(b)):
            continue
        want, got = positional(a), positional(b)
        if got[-1:] == ["device"] and want[-1:] != ["device"]:
            got = got[:-1]
        assert got == want, f"{pkg}.{name}: {got} != {want}"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_classes_and_registries_keep_their_members(pkg):
    ref, port = modules(pkg)
    for name in sorted(public(ref) & public(port)):
        a, b = getattr(ref, name), getattr(port, name)
        if inspect.isclass(a) and inspect.isclass(b):
            lost = sorted(members(a) - members(b))
            assert not lost, f"{pkg}.{name} lacks {lost}"
        elif type(a).__name__ == "PolicyRegistry":
            lost = sorted(members(type(a)) - members(type(b)))
            assert not lost, f"{pkg}.{name} lacks {lost}"


def test_device_defaults_to_the_card():
    """``cluster_events`` and ``init_cluster`` take the reference's
    calls: ``device`` is optional and ``None`` resolves as ``simulate``
    does (the CUDA device, or a raise without one; never a silent CPU)."""
    import torch
    from repro_torch.cluster import (ClusterConfig, cluster_events,
                                     init_cluster)
    from repro_torch.workloads import quickstart_trace
    for fn in (cluster_events, init_cluster):
        assert inspect.signature(fn).parameters["device"].default is None
    cfg = ClusterConfig.homogeneous(2, 1024.0, max_slots=8)
    tr = quickstart_trace().head(5)
    assert init_cluster(cfg, "cpu").valid.shape == (4, 8)
    assert cluster_events(tr, 2, "cpu").t.shape == (5,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_cluster(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cluster_events(tr, 2)


def test_homogeneous_and_on_register_match_the_reference():
    ref, port = modules("core")
    for kiss in (True, False):
        a = ref.ClusterConfig.homogeneous(3, 2048.0, kiss=kiss,
                                          small_frac=0.7, max_slots=16)
        b = port.ClusterConfig.homogeneous(3, 2048.0, kiss=kiss,
                                           small_frac=0.7, max_slots=16)
        assert (a.node_mb, a.small_frac, a.unified, a.max_slots) == \
            (b.node_mb, b.small_frac, b.unified, b.max_slots)
        assert (a.pool_caps() == b.pool_caps()).all()
    from repro_torch.core.registry import PolicyRegistry
    reg, calls = PolicyRegistry("test"), []

    def hook():
        calls.append(len(reg))
    reg.on_register(hook)
    reg.on_register(hook)                       # registered once
    reg.register("a")(lambda xp, ctx: ctx)
    reg.register("b")(lambda xp, ctx: ctx)
    assert calls == [1, 2]


def test_exports_the_slice_names():
    from repro_torch.cluster import Autoscale, Failures
    from repro_torch.core.continuum import Autoscale as A, Failures as F
    from repro_torch.sim import run_manifest, sweep, write_manifest
    from repro_torch.sim.telemetry import run_manifest as rm
    assert (Autoscale, Failures) == (A, F)
    assert run_manifest is rm and callable(sweep) and callable(write_manifest)


# ---------------------------------------------------------------------------
# the model stack and the serving entry point
# ---------------------------------------------------------------------------

#: Public names of the reference's model and serving modules that the
#: port does not have yet, with the ROADMAP item that ports them.
MODEL_PENDING = {
    "models": {},
    "models.moe": {},
    "models.whisper": {},
    "models.frontends": {},
    "models.rope": {},
    "launch.serve": {},
    "optim": {},
    "data": {},
    "checkpoint": {},
    "launch.train": {},
    "models.sharding": {},
    "models.partitioning": {},
    "launch.specs": {},
    "launch.mesh": {},
    "launch": {},
    "launch.steps": {},
}
#: The reference's inits and stubs take a ``jax.random`` key; the port's
#: take a seed (``init_params``) or a ``torch.Generator`` in its place.
KEY_NAMES = ("gen", "seed")


def defined(mod) -> set:
    """``__all__``, or else the functions and classes the module itself
    defines (not what it imports)."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


@pytest.mark.parametrize("name", sorted(MODEL_PENDING))
def test_model_names_are_ported(name):
    ref, port = modules(name)
    pending = set(MODEL_PENDING[name])
    missing = sorted(defined(ref) - defined(port) - pending)
    assert not missing, f"repro_torch.{name} lacks {missing}"
    landed = sorted(pending & defined(port))
    assert not landed, f"repro_torch.{name} has {landed}: drop them " \
        "from MODEL_PENDING"
    assert pending <= defined(ref)


@pytest.mark.parametrize("name", sorted(MODEL_PENDING))
def test_model_functions_keep_their_parameters(name):
    """Positional parameters as the reference's, the port adding at most
    a trailing ``device`` and taking a seed or a generator where the
    reference takes a key; a class keeps the reference's members."""
    ref, port = modules(name)
    for fn in sorted(defined(ref) & defined(port)):
        a, b = getattr(ref, fn), getattr(port, fn)
        if inspect.isclass(a):
            lost = sorted(members(a) - members(b))
            assert not lost, f"{name}.{fn} lacks {lost}"
            continue
        if not inspect.isfunction(a):
            continue
        want, got = positional(a), positional(b)
        if got[-1:] == ["device"] and want[-1:] != ["device"]:
            got = got[:-1]
        assert len(got) == len(want), f"{name}.{fn}: {got} != {want}"
        for w, g in zip(want, got):
            assert g == w or (w == "key" and g in KEY_NAMES), \
                f"{name}.{fn}: {got} != {want}"


#: ``launch.dryrun``'s parameters that the port names otherwise:
#: ``collective_stats`` reads the port's record of the collectives a step
#: issued (``(op, bytes)`` pairs), not the HLO text the reference parses.
DRYRUN_RENAMED = {("collective_stats", "hlo_text"): "ops"}


def test_dryrun_names_and_parameters():
    """``launch.dryrun``'s public functions and their positional
    parameters, the reference's read from its source with ``ast``:
    importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
    devices, which every later JAX test of the process would see."""
    import ast
    import sys
    from pathlib import Path

    import repro_torch.launch.dryrun as port
    src = Path(__file__).resolve().parents[1] / "src/repro/launch/dryrun.py"
    tree = ast.parse(src.read_text())
    ref = {n.name: [a.arg for a in n.args.posonlyargs + n.args.args]
           for n in tree.body if isinstance(n, ast.FunctionDef)
           and not n.name.startswith("_")}
    assert sorted(ref) == ["collective_stats", "main", "run_one"]
    for name, params in ref.items():
        want = [DRYRUN_RENAMED.get((name, p), p) for p in params]
        assert positional(getattr(port, name)) == want, name
    assert "repro.launch.dryrun" not in sys.modules
