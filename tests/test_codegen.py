"""SaveAsCode codegen: compiled model == JSON-loaded model.

The generated module must construct systems explicitly (no JSON parsing)
and step bit-identically to the EngineView binding (the reference's
Model.Codegen.cs contract: LoadCompiledModel behaves like the .fx file,
TestGame.cs:93-95).
"""

import numpy as np

from illuminant.models.codegen import save_as_code
from illuminant.models.model import EngineModel
from illuminant.models.view import EngineView

MODEL_JSON = """
{
  "NamedVariables": {
    "rate": {"ValueType": "System.Single", "Constant": 300.0}
  },
  "Systems": [
    {
      "Name": "sparks",
      "UpdateOrder": 0,
      "Configuration": {
        "LifeDecayPerSecond": 1.0,
        "Friction": 0.2,
        "MaximumVelocity": 500.0
      },
      "Transforms": [
        {
          "Type": "Squared.Illuminant.Particles.Transforms.Spawner",
          "UpdateOrder": 0,
          "Properties": {
            "MinRate": {"Type": "System.Object",
                        "Value": {"Name": "rate"}},
            "MaxRate": {"Type": "System.Object",
                        "Value": {"Name": "rate"}},
            "Life": {"Type": "System.Object",
                     "Value": {"Constant": 3.0, "RandomScale": 1.0}},
            "Position": {"Type": "System.Object",
                         "Value": {"Constant": [100.0, 100.0, 0.0],
                                   "RandomScale": [20.0, 20.0, 0.0],
                                   "Type": "Spherical"}},
            "Velocity": {"Type": "System.Object",
                         "Value": {"RandomScale": [50.0, 50.0, 0.0],
                                   "Type": "Spherical"}},
            "Color": {"Type": "System.Object",
                      "Value": {"Constant": [1.0, 0.5, 0.25, 1.0]}}
          }
        },
        {
          "Type": "Squared.Illuminant.Particles.Transforms.Gravity",
          "UpdateOrder": 1,
          "Properties": {
            "Attractors": {"Type": "System.Object", "Value": [
              {"Position": [100.0, 200.0, 0.0], "Radius": 300.0,
               "Strength": 80.0, "FalloffType": "Linear"}
            ]},
            "MaximumAcceleration": {"Type": "System.Object",
                                    "Value": 1000.0}
          }
        }
      ]
    }
  ]
}
"""


def test_codegen_compiles_and_matches_json_loader():
    model = EngineModel.loads(MODEL_JSON)
    src = save_as_code(model)

    # No JSON round-trip inside the generated module.
    assert "loads(" not in src and "MODEL_JSON" not in src
    assert "Spawner(" in src and "Gravity(" in src
    assert "Attractor(" in src

    ns: dict = {}
    exec(compile(src, "<generated>", "exec"), ns)
    compiled_systems = ns["build_systems"](capacity=1 << 10)
    assert len(compiled_systems) == 1

    view = EngineView(model, capacity=1 << 10)
    ref_system = view.systems[0].system
    gen_system = compiled_systems[0]

    for _ in range(20):
        ref_system.update(1.0 / 60.0)
        gen_system.update(1.0 / 60.0)

    assert ref_system.live_count > 0
    np.testing.assert_array_equal(
        np.asarray(ref_system.state.position),
        np.asarray(gen_system.state.position),
    )
    np.testing.assert_array_equal(
        np.asarray(ref_system.state.velocity),
        np.asarray(gen_system.state.velocity),
    )
    np.testing.assert_array_equal(
        np.asarray(ref_system.state.color),
        np.asarray(gen_system.state.color),
    )

    # Named variables survive into the compiled form.
    assert ns["NAMED_VARIABLES"]["rate"][0] == [300.0]


def test_codegen_empty_model():
    src = save_as_code(EngineModel())
    ns: dict = {}
    exec(compile(src, "<generated>", "exec"), ns)
    assert ns["build_systems"]() == []
