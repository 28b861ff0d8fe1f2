"""Offline RL: sample IO and off-policy evaluation (counterpart of
``ray_tpu/rllib/offline``; reference: rllib/offline/ — JsonWriter and
JsonReader (json_writer.py:30, json_reader.py:43) and the OPE estimators
(offline/estimators/importance_sampling.py,
weighted_importance_sampling.py)).  BC and MARWIL, which read these
files, are ``algorithms/bc.py`` and ``algorithms/marwil.py``.

Numpy only, as in the JAX package: the files are the JAX package's
format line for line (one JSON object a line, arrays as nested lists),
so each package reads the other's."""
from ray_tpu_torch.rllib.offline.io import JsonReader, JsonWriter  # noqa: F401
from ray_tpu_torch.rllib.offline.estimators import (  # noqa: F401
    ImportanceSampling,
    WeightedImportanceSampling,
)
