"""The model side's decoder stack, PyTorch port of ``repro.models``:
``config`` (``ModelConfig``, ``MoEConfig``), ``params`` (``ParamDef``,
``init_tree``), ``layers``, ``moe``, ``rglru``, ``rwkv`` and
``transformer`` (``Decoder``, ``init_params``, ``init_cache``,
``forward``)."""
