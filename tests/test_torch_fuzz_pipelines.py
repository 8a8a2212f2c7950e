"""Torch port: random knob draws (test_fuzz_configs._random_config) on the
four pipelines the JAX file's draws do not reach, against JAX's
pallas_interpret frame and the oracle (test_torch_fuzz.py).
"""

import pytest
import torch

from test_torch_fuzz import random_knobs_draw


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("seed,pipeline", [(14, "default"), (15, "normal_map"), (16, "specular"),
                                           (17, "darboux")])
def test_fuzz_random_knobs(seed, pipeline):
    random_knobs_draw(seed, pipeline)
