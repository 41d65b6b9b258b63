"""Model layer: parameter/bezier JSON, model round-trip, view binding."""

import json

import numpy as np

from illuminant.models.model import EngineModel
from illuminant.models.parameter import (
    Bezier,
    MODE_LOOP,
    MODE_SINE,
    Parameter,
)
from illuminant.models.view import EngineView

SAMPLE = {
    "NamedVariables": {
        "rate": {
            "DefaultValue": {
                "ValueType": "System.Single",
                "Constant": 600.0,
            },
            "IsExternal": True,
        },
        "tint": {
            "DefaultValue": {
                "ValueType": "Microsoft.Xna.Framework.Vector4",
                "Constant": {"X": 1.0, "Y": 0.5, "Z": 0.25, "W": 1.0},
            },
            "IsExternal": False,
        },
    },
    "Systems": [
        {
            "Name": "sparks",
            "UpdateOrder": 0,
            "DrawOrder": 0,
            "AdditiveBlend": True,
            "Configuration": {
                "LifeDecayPerSecond": 0.0,
                "MaximumVelocity": 1000.0,
                "Friction": 0.0,
                "UpdatesPerSecond": 0.0,
            },
            "Transforms": [
                {
                    "Name": "emit",
                    "Type": "Squared.Illuminant.Particles.Transforms.Spawner",
                    "UpdateOrder": 0,
                    "Properties": {
                        "MinRate": {
                            "Type": "System.Object",
                            "Value": {"ValueType": "System.Single",
                                      "Name": "rate"},
                        },
                        "MaxRate": {
                            "Type": "System.Object",
                            "Value": {"ValueType": "System.Single",
                                      "Name": "rate"},
                        },
                        "Life": {
                            "Type": "System.Object",
                            "Value": {
                                "Constant": {
                                    "ValueType": "System.Single",
                                    "Constant": 5.0,
                                }
                            },
                        },
                        "Position": {
                            "Type": "System.Object",
                            "Value": {
                                "Constant": {
                                    "ValueType":
                                        "Microsoft.Xna.Framework.Vector3",
                                    "Constant": {"X": 10.0, "Y": 20.0,
                                                 "Z": 0.0},
                                }
                            },
                        },
                    },
                },
                {
                    "Name": "pull",
                    "Type":
                        "Squared.Illuminant.Particles.Transforms.Gravity",
                    "UpdateOrder": 1,
                    "Properties": {
                        "Attractors": {
                            "Type": "System.Object",
                            "Value": None,
                        }
                    },
                },
            ],
        }
    ],
    "UserData": {"EditorData": {"Zoom": 2}},
}
# Fix the Attractors entry to a list form.
SAMPLE["Systems"][0]["Transforms"][1]["Properties"]["Attractors"] = {
    "Type": "System.Object",
    "Value": [
        {
            "Position": {
                "ValueType": "Microsoft.Xna.Framework.Vector3",
                "Constant": {"X": 100.0, "Y": 0.0, "Z": 0.0},
            },
            "Radius": {"ValueType": "System.Single", "Constant": 400.0},
            "Strength": {"ValueType": "System.Single", "Constant": 50.0},
            "FalloffType": "Linear",
        }
    ],
}


def test_parameter_constant_and_named():
    p = Parameter.from_json({"ValueType": "System.Single", "Constant": 3.5})
    np.testing.assert_allclose(p.evaluate(0.0), [3.5])

    resolver = lambda name, t: 7.0 if name == "x" else None
    p2 = Parameter.from_json({"ValueType": "System.Single", "Name": "x"})
    np.testing.assert_allclose(p2.evaluate(0.0, resolver), [7.0])


def test_parameter_bezier_json_roundtrip():
    b = Bezier(
        points=[np.asarray([0.0], np.float32), np.asarray([4.0], np.float32)],
        min_value=0.0,
        max_value=2.0,
        mode=MODE_SINE,
    )
    j = b.to_json()
    b2 = Bezier.from_json(j)
    for t in (0.0, 0.5, 1.0, 1.7, 2.0):
        np.testing.assert_allclose(b2.evaluate(t), b.evaluate(t))
    # matches the device evaluator
    from illuminant.ops.bezier import evaluate_bezier

    packed = b.packed()
    for t in (0.0, 0.5, 1.3, 2.0):
        np.testing.assert_allclose(
            np.asarray(evaluate_bezier(packed, t)),
            b.evaluate(t),
            rtol=1e-5, atol=1e-6,
        )


def test_parameter_expression():
    p = Parameter.from_json(
        {
            "ValueType": "System.Single",
            "Expression": {
                "LeftHandSide": {"ValueType": "System.Single",
                                 "Constant": 3.0},
                "Operator": "Multiply",
                "RightHandSide": {"ValueType": "System.Single",
                                  "Constant": 4.0},
            },
        }
    )
    np.testing.assert_allclose(p.evaluate(0.0), [12.0])


def test_model_roundtrip(tmp_path):
    model = EngineModel.loads(json.dumps(SAMPLE))
    assert len(model.systems) == 1
    assert model.systems[0].additive_blend
    assert model.systems[0].transforms[0].type == "Spawner"
    assert model.user_data["EditorData"]["Zoom"] == 2

    path = str(tmp_path / "scene.json")
    model.save(path)
    model2 = EngineModel.load(path)
    assert len(model2.systems) == 1
    assert model2.systems[0].transforms[1].type == "Gravity"
    assert "rate" in model2.named_variables


def test_named_variable_resolution():
    model = EngineModel.loads(json.dumps(SAMPLE))
    resolve = model.make_resolver()
    np.testing.assert_allclose(resolve("rate", 0.0), [600.0])
    np.testing.assert_allclose(resolve("tint", 0.0), [1.0, 0.5, 0.25, 1.0])
    assert resolve("missing", 0.0) is None
    # Overrides shadow defaults (the editor's external variables).
    r2 = model.make_resolver({"rate": 50.0})
    np.testing.assert_allclose(r2("rate", 0.0), [50.0])


def test_view_instantiates_and_runs():
    model = EngineModel.loads(json.dumps(SAMPLE))
    view = EngineView(model, capacity=2048)
    assert len(view.systems) == 1
    system = view.systems[0].system
    assert len(system.spawners) == 1
    assert len(system.modifiers) == 1
    for _ in range(30):
        system.tick(1.0 / 60.0)
    assert view.live_count == 300  # 600/s * 0.5s
    # Gravity pulled spawned particles toward +x.
    live = np.asarray(system.state.live_mask())
    vel = np.asarray(system.state.velocity)[live]
    assert vel[:, 0].mean() > 0.01


def test_save_as_code_roundtrip(tmp_path):
    from illuminant.models.model import save_as_code

    model = EngineModel.loads(json.dumps(SAMPLE))
    src = save_as_code(model)
    path = tmp_path / "compiled_scene.py"
    path.write_text(src)
    import importlib.util

    spec = importlib.util.spec_from_file_location("compiled_scene", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    systems = mod.build_systems(capacity=512)
    systems[0].tick(1.0 / 60.0)
    assert systems[0].live_count == 10  # 600/s / 60


def test_deterministic_replay():
    # Same seeds -> bit-identical state after N ticks (the MockTimeProvider
    # deterministic-stepping story, ParticleEditor/View.cs:34-39).
    model = EngineModel.loads(json.dumps(SAMPLE))

    def run():
        view = EngineView(model, capacity=1024)
        s = view.systems[0].system
        for _ in range(20):
            s.tick(1.0 / 60.0)
        return np.asarray(s.state.position), np.asarray(s.state.velocity)

    p1, v1 = run()
    p2, v2 = run()
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(v1, v2)


def test_view_binding_review_fixes():
    """Round-3 review fixes in the model->engine binding."""
    import numpy as np
    from illuminant.models.model import (
        EngineModel, SystemModel, TransformModel)
    from illuminant.models.view import EngineView, instantiate_transform
    from illuminant.particles import transforms as tx
    from illuminant.particles.spawner import FeedbackSpawner

    # Sensor instantiates (was ValueError though the engine supports it).
    s = instantiate_transform(
        TransformModel(type="Sensor", name="s"), None)
    assert isinstance(s, tx.Sensor)

    # Attractor falloff from the reference's integer "Type" key.
    g = instantiate_transform(TransformModel(type="Gravity", name="g",
        properties={"Attractors": [
            {"Position": [0, 0, 0], "Radius": 10.0, "Strength": 5.0,
             "Type": 2}]}), None)
    assert g.attractors[0].falloff_type == 2
    # MaximumAcceleration: reference default 8; explicit 0 honored.
    assert g.maximum_acceleration == 8.0
    g0 = instantiate_transform(TransformModel(type="Gravity", name="g",
        properties={"Attractors": [], "MaximumAcceleration": 0.0}), None)
    assert g0.maximum_acceleration == 0.0

    # Life defaults to 1 (Formula1.One) when absent.
    sp = instantiate_transform(TransformModel(type="Spawner", name="sp",
        properties={"MinRate": 60.0, "MaxRate": 60.0}), None)
    assert sp.life.constant == 1.0
    # Explicit MaximumTotal=0 disables the spawner (not unbounded).
    sp0 = instantiate_transform(TransformModel(type="Spawner", name="sp",
        properties={"MinRate": 60.0, "MaxRate": 60.0,
                    "MaximumTotal": 0}), None)
    assert sp0.maximum_total == 0
    assert sp0.begin_tick(0.0, 1.0) == 0

    # FeedbackSpawner instantiates as its real class and wires its
    # source system by name.
    m = EngineModel(systems=[
        SystemModel(name="src", transforms=[
            TransformModel(type="Spawner", name="s",
                           properties={"MinRate": 60.0, "MaxRate": 60.0})]),
        SystemModel(name="dst", transforms=[
            TransformModel(type="FeedbackSpawner", name="f",
                           properties={"MinRate": 30.0, "MaxRate": 30.0,
                                       "SourceSystem": "src",
                                       "InstanceMultiplier": 2})]),
    ])
    view = EngineView(m, capacity=1 << 10)
    fb = view.systems[1].system.transforms[0]
    assert isinstance(fb, FeedbackSpawner)
    assert fb.source is view.systems[0].system
    assert fb.instance_multiplier == 2


def test_view_bezier_parameters_animate():
    """Bezier-animated transform parameters advance with view time (the
    reference evaluates Parameters at `now` every frame; they were
    frozen at t=0)."""
    from illuminant.models.model import (
        EngineModel, SystemModel, TransformModel)
    from illuminant.models.view import EngineView

    bez = {"Bezier": {"Mode": 0, "Count": 2, "MinValue": 0.0,
                      "MaxValue": 1.0, "A": 0.0, "B": 100.0}}
    m = EngineModel(systems=[SystemModel(name="s", transforms=[
        TransformModel(type="Gravity", name="g", properties={
            "Attractors": [{"Position": [0, 0, 0], "Radius": 50.0,
                            "Strength": bez, "Type": 1}],
            "MaximumAcceleration": 100.0,
        })])])
    view = EngineView(m, capacity=1 << 8)
    assert view._animated
    g0 = view.systems[0].system.transforms[0].attractors[0].strength
    for _ in range(30):
        view.update(1.0 / 60.0)
    g1 = view.systems[0].system.transforms[0].attractors[0].strength
    assert g1 > g0 + 10.0, (g0, g1)
