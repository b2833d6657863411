"""The port's config layer against the JAX package's.

``core/config.py`` (the typed kernel, ``resolve_class``, ``load_properties``)
and ``core/config_defs.py`` (the merged registry).  The cases of
``tests/test_config.py`` run unchanged against the port
(``port_test_module``).  Then the registries key for key: name, type, default
(a class default module for module), importance and what the validator
accepts; the shipped properties file resolved alike; resolving every class
default in a fresh interpreter imports neither JAX nor the JAX package; and
the controller's and fleet's knob blocks default to the registry's values.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from tests.torch_port_helpers import port_test_module

_PORTED = port_test_module("test_config")
# every case of the JAX file, bound under its own name
for _name in [n for n in vars(_PORTED) if n.startswith("test_")]:
    globals()[_name] = getattr(_PORTED, _name)
del _name

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROPERTIES = os.path.join(_REPO, "config", "cruisecontrol.properties")
_JAX_ROOT, _PORT_ROOT = "cruise_control_tpu.", "cruise_control_tpu_torch."


def _registries():
    from cruise_control_tpu.core.config_defs import cruise_control_config as jax_config
    from cruise_control_tpu_torch.core.config_defs import cruise_control_config

    return jax_config().keys(), cruise_control_config().keys()


def _probe_values(jkey, pkey):
    """Values to run a key's validators on: numbers across the usual bounds,
    the default, and every value either validator names."""
    values = [-1e9, -1, -0.5, 0, 1e-6, 0.25, 0.5, 0.995, 1, 1.5, 2, 100, 1e9, "nope"]
    for key in (jkey, pkey):
        values.append(key.default)
        for cell in (key.validator.__closure__ or ()) if key.validator else ():
            content = cell.cell_contents
            values.extend(content if isinstance(content, tuple) else [content])
    return values


def _outcome(validator, name, value):
    from cruise_control_tpu.core.config import ConfigException as JaxConfigException
    from cruise_control_tpu_torch.core.config import ConfigException

    if validator is None:
        return "none"
    try:
        validator(name, value)
    except (ConfigException, JaxConfigException):
        return "refused"
    except TypeError:
        return "type"
    return "accepted"


def test_every_key_equals_the_jax_key():
    jax_keys, port_keys = _registries()
    assert list(port_keys) == list(jax_keys)
    for name, j in jax_keys.items():
        p = port_keys[name]
        assert (p.type.value, p.importance.value, p.has_default) == (j.type.value, j.importance.value,
                                                                      j.has_default), name
        if j.type.value == "class":
            assert j.default.startswith(_JAX_ROOT) and p.default == _PORT_ROOT + j.default[len(_JAX_ROOT):], name
        else:
            assert p.default == j.default, name
        for value in _probe_values(j, p):
            assert _outcome(p.validator, name, value) == _outcome(j.validator, name, value), (name, value)


def test_every_class_default_resolves_to_its_port_counterpart():
    from cruise_control_tpu_torch.core.config import ConfigException, resolve_class

    _, port_keys = _registries()
    classes = {n: k.default for n, k in port_keys.items() if k.type.value == "class"}
    assert len(classes) == 6
    for name, spec in classes.items():
        cls = resolve_class(spec)
        assert f"{cls.__module__}.{cls.__name__}" == spec, name
        jax_spec = _JAX_ROOT + spec[len(_PORT_ROOT):]
        with pytest.raises(ConfigException, match=spec.replace(".", r"\.")):
            resolve_class(jax_spec)


def test_the_shipped_properties_resolve_alike():
    from cruise_control_tpu.app import load_properties as jax_load_properties
    from cruise_control_tpu.core.config import Config as JaxConfig
    from cruise_control_tpu.core.config_defs import cruise_control_config as jax_config
    from cruise_control_tpu_torch.core.config import Config, load_properties
    from cruise_control_tpu_torch.core.config_defs import cruise_control_config

    props = load_properties(_PROPERTIES)
    assert props == jax_load_properties(_PROPERTIES) and props
    jcfg, pcfg = JaxConfig(jax_config(), props), Config(cruise_control_config(), props)
    assert pcfg.unknown() == jcfg.unknown()
    jvals, pvals = jcfg.to_dict(), pcfg.to_dict()
    assert set(pvals) == set(jvals)
    for name, value in jvals.items():
        expected = _PORT_ROOT + value[len(_JAX_ROOT):] if isinstance(value, str) and value.startswith(
            _JAX_ROOT) else value
        assert pvals[name] == expected, name


def test_resolving_the_class_defaults_imports_no_jax():
    """In a fresh interpreter: parse the shipped properties, resolve every
    class default; neither JAX nor the JAX package gets imported."""
    script = (
        "import sys\n"
        "from cruise_control_tpu_torch.core.config import Config, load_properties, resolve_class\n"
        "from cruise_control_tpu_torch.core.config_defs import cruise_control_config\n"
        f"cfg = Config(cruise_control_config(), load_properties({_PROPERTIES!r}))\n"
        "n = [resolve_class(cfg.get(k)) for k, key in cfg.definition.keys().items() if key.type.value == 'class']\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cruise_control_tpu')]\n"
        "print(len(n), bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-S", "-c", f"import sys; sys.path[:0] = {sys.path!r}; " + script],
                         cwd=_REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["6", "[]"]


@pytest.mark.parametrize("block", ["controller", "fleet"])
def test_knob_blocks_default_to_the_registry(block):
    """``ControllerConfig`` and ``FleetConfig`` copy their defaults by hand:
    each equals the port's ``controller_config()`` / ``fleet_config()``
    default (seconds where the key is in ms), and the JAX registry's."""
    import dataclasses

    from cruise_control_tpu.core import config_defs as jax_defs
    from cruise_control_tpu_torch.controller import ControllerConfig
    from cruise_control_tpu_torch.core import config_defs
    from cruise_control_tpu_torch.fleet import FleetConfig

    cls = ControllerConfig if block == "controller" else FleetConfig
    keys = {"tick_interval_s": "tick.interval.ms", "drift_threshold": "drift.threshold",
            "max_rounds_per_tick": "max.rounds.per.tick", "stale_after_s": "stale.after.ms",
            "execute": "execute.enable", "max_concurrent_drains": "max.concurrent.drains",
            "drain_stagger_s": "drain.stagger.ms"}
    fields = {f.name: f.default for f in dataclasses.fields(cls)}
    assert set(fields) <= set(keys)
    for defs in (config_defs, jax_defs):
        registry = getattr(defs, f"{block}_config")().keys()
        for field, default in fields.items():
            key = registry[f"{block}.{keys[field]}"]
            expected = key.default / 1000.0 if key.name.endswith(".ms") else key.default
            assert default == expected and type(default) is type(expected), (defs.__name__, field)
