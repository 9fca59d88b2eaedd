"""Small sizes of the cells for the CPU: the same drivers, traffic shapes
and checks on a grid and a model that a test run holds."""

SURVEY = {"config": {"nz": 20, "ny": 40, "nx": 40}}
UNIFORM = {**SURVEY, "traffic": {"shots": [{"count": 12, "nt": 30}]}}
BIMODAL = {**SURVEY, "traffic": {"shots": [{"count": 14, "nt": 10}, {"count": 2, "nt": 80}]}}
TRAIN = {"config": {"hidden_size": 48, "intermediate_size": 96, "num_attention_heads": 6,
                    "num_key_value_heads": 2, "head_dim": 8, "num_hidden_layers": 2,
                    "vocab_size": 256},
         "traffic": {"seq": 32}}
CELLS = {"overthrust-uniform": UNIFORM, "overthrust-bimodal": BIMODAL, "phi4-hetdp-train": TRAIN}
