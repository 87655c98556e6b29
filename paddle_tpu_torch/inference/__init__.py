"""Inference engine: a predictor over saved inference models.

Counterpart of ``paddle_tpu/inference/__init__.py`` (role parity:
reference paddle/fluid/inference/ -- AnalysisConfig + AnalysisPredictor,
api/analysis_predictor.h:82, Run:120).  ``Predictor`` loads the program
and parameters that ``fluid.io.save_inference_model`` wrote into a scope
of its own and runs them through the port's ``Executor``, whose graph
passes do the reference's analysis: fused attention, and weight-only
quantization under ``FLAGS_weight_quant`` or ``slim.mark_weight_quant``
(int8 / fp8 carriers through the B7 kernel).  The pass result is cached
per feed names, so a new batch size reuses it.

Devices: a ``Config()`` serves on the accelerator, the CUDA card
(``cuda:0``); ``enable_tpu(device_id)`` keeps the JAX package's name and
picks ``cuda:<device_id>``; ``disable_gpu()`` serves on the CPU, where
every kernel takes its plain PyTorch version.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np


class Config:
    """AnalysisConfig parity: where the model lives + execution knobs."""

    def __init__(self, model_dir: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_dir = model_dir
        self._model_filename = None
        self._params_filename = params_file
        self._device_id = 0
        self._use_tpu = True    # the accelerator: the CUDA card here

    def set_model(self, model_dir: str, params_file: Optional[str] = None):
        self._model_dir = model_dir
        self._params_filename = params_file

    def model_dir(self) -> Optional[str]:
        return self._model_dir

    def enable_tpu(self, device_id: int = 0):
        """Serve on the accelerator, card ``device_id`` (the JAX
        package's name for it)."""
        self._use_tpu = True
        self._device_id = device_id

    def disable_gpu(self):
        """Serve on the CPU (the kernels' plain versions)."""
        self._use_tpu = False

    # reference knobs that the executor's passes own: accepted, no-op
    def switch_ir_optim(self, enable: bool = True):
        pass

    def enable_memory_optim(self):
        pass


class Predictor:
    """Server for a saved inference model.

    Reference AnalysisPredictor: load program+params, run analysis passes,
    execute.  Here: load program+params into this predictor's own scope,
    let the Executor's pass cache hold the rewritten program per feed
    names, and run it op by op on the device.
    """

    def __init__(self, config: Union[Config, str]):
        from ..fluid.io import load_inference_model
        from ..framework.executor import Executor
        from ..framework.place import CPUPlace, CUDAPlace
        from ..framework.scope import Scope, _switch_scope

        if isinstance(config, str):
            config = Config(config)
        if config.model_dir() is None:
            raise ValueError("Config has no model dir; call set_model()")
        self._config = config
        self._scope = Scope()
        place = CUDAPlace(config._device_id) if config._use_tpu \
            else CPUPlace()
        self._exe = Executor(place)
        # load into THIS predictor's scope -- never clobber live variables
        # in the process-global scope
        old = _switch_scope(self._scope)
        try:
            program, feed_names, fetch_targets = load_inference_model(
                config.model_dir(), self._exe,
                model_filename=config._model_filename,
                params_filename=config._params_filename)
        finally:
            _switch_scope(old)
        self._program = program
        self._feed_names = list(feed_names)
        self._fetch_targets = fetch_targets

    # -- reference API ----------------------------------------------------
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return [v.name for v in self._fetch_targets]

    def run(self, feeds: Union[Dict[str, np.ndarray],
                               Sequence[np.ndarray]]):
        """One inference call: the outputs as numpy arrays, in the order
        of ``get_output_names``."""
        if not isinstance(feeds, dict):
            if len(feeds) != len(self._feed_names):
                raise ValueError(
                    f"expected {len(self._feed_names)} inputs "
                    f"{self._feed_names}, got {len(feeds)}")
            feeds = dict(zip(self._feed_names, feeds))
        missing = [n for n in self._feed_names if n not in feeds]
        if missing:
            raise KeyError(f"missing inputs: {missing}")
        return self._exe.run(self._program, feed=feeds,
                             fetch_list=self._fetch_targets,
                             scope=self._scope)


def create_predictor(config: Config) -> Predictor:
    """Reference paddle_infer.create_predictor."""
    return Predictor(config)
