"""ulcx_torch — the ulcx codec ported to PyTorch and CUDA.

A second implementation of the ``ulcx`` package for NVIDIA Hopper
GPUs. ``ulcx`` (JAX/Pallas) stays the reference; each module here
mirrors the module of the same name there and is tested against it.

Ported so far are the batched and the single-stream encode and decode
paths. ``parallel.mesh.batch_encode`` -> ``codec.encoder.encode_stream_batched``
-> analysis (per block, or once over all blocks with ``flat_stream``)
-> ``bitstream.fast_encode`` rate search and materialization (per block,
or per chunk of ``fold_bitstream`` blocks), whose four serial walks are
CUDA C++ kernels (``csrc/encode_walks.cu``). ``parallel.mesh.batch_decode``
-> ``codec.decoder.decode_stream_batched`` -> per block
``bitstream.fast_decode.decode_block_fast`` (FSM kernel, which places
each record's expansion word, then the RNG-expand kernel;
``csrc/decode_walks.cu``) -> ``codec.transform_batched.block_imdct_batched``
(one kernel, ``csrc/imdct.cu``: each row's active subblocks by a fast
DCT-IV, then their windows and lap) -> inverse M/S. ``codec.encoder.encode_stream`` / ``encode_block`` and
``codec.decoder.decode_stream`` / ``decode_block`` code one stream as a
batch of one; ``codec.decoder.decode_stream_pipelined`` decodes it with
only the state machine serial (``ops.rngjump`` gives every block its RNG
state). Every setting the configuration admits is served: every
P = n_chan * block_size, ``rate_search="bisect"``, ``use_pallas="off"``
(the plain versions on any device) and ``noise_run_window="gap"`` (the
reference's exact noise-run window, whose emission walks run their plain
versions' gap mode, as ulcx runs it on its scan path). The entry points
run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``; below them every function follows the device of its
input tensors: on the CPU the kernels run their plain PyTorch versions,
on a CUDA device the kernels.

Data parallelism over GPUs: ``parallel.mesh.data_mesh`` builds one
rank's mesh (a ``torch.distributed`` process group and a one-dimension
``DeviceMesh`` named "data", one process a device under ``torchrun``),
and ``batch_encode`` / ``batch_decode`` with ``mesh=`` code the rank's
contiguous shard of the global batch, the two encode metrics all-reduced
in ulcx's float32 form. ``graft_entry`` is the counterpart of the repo's
``__graft_entry__.py``: ``entry()`` (one batched CBR-128 block step) and
``dryrun_multichip(n)`` (ulcx's two dry-run phases over ``n`` ranks it
launches under ``torchrun``), and the rank code those launches run.

The runtime surface is the CLI trio, on the card:
``python -m ulcx_torch.tools.encode_tool`` (WAV -> ``.ulc`` through
``encode_stream``), ``python -m ulcx_torch.tools.decode_tool`` (``.ulc``
-> WAV through ``decode_stream_pipelined``) and
``python -m ulcx_torch.tools.batch_tool`` (a corpus through
``encode_stream_batched``), with ulcx's flags, messages and exit codes;
their ``main(argv, device="cpu")`` runs on the CPU. Beside them:
``container`` (the ULC2 header), ``io.wavio`` / ``io.miniriff`` /
``io.native`` (WAV I/O, the repo's ``native/libulcio.so`` when it
loads), ``utils.checkpoint`` (carries to ``.npz`` in ulcx's layout, so
each package loads the other's) and ``utils.profiling``
(``torch.profiler`` traces, ``-profile:DIR``).

Nothing here imports jax or ``ulcx``: the port keeps its own copy of
what it needs (``utils.config``, ``ops.patterns``, ``bitstream.tables``,
the container and I/O modules).
"""

__version__ = "0.1.0"

from ulcx_torch.utils.config import CodecConfig  # noqa: F401
