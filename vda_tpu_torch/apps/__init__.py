"""The port's entry points, each run as
``python -m vda_tpu_torch.apps.<name>``:

  * ``run``: offline video depth (the counterpart of ``apps/run.py``)
  * ``run_streaming``: causal streaming, ``--lookahead`` groups through
    ``StreamingDepth.submit_group`` (``apps/run_streaming.py``)
  * ``benchmark_infer``: a benchmark manifest to per-frame ``.npy``
    predictions (``benchmark/infer/infer.py``)
  * ``train``: fine-tuning (``apps/train.py``)
  * ``engine.engine``: the VFX job and queue daemon (``apps/engine/``)
  * ``colab_processor``: image sequences to EXR depth
    (``apps/colab_processor.py``)
  * ``app``: the Gradio demo (``apps/app.py``)

Each has its JAX counterpart's flags and outputs and runs on the card
unless the caller asks for the CPU (``--device cpu``).
"""
