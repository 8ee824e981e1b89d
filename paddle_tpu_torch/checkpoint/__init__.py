"""paddle_tpu_torch.checkpoint — versioned, verifiable model checkpoints
(the counterpart of ``paddle_tpu.checkpoint``; the on-disk format is the
same byte for byte, so either package loads what the other saved).

A manifest JSON indexes per-tensor raw binary segments (dtype / shape /
byte offset / crc32) in a nonce-named payload file; commits are atomic
(tmp + fsync + rename — the ``checkpoint.save`` fault site sits at the
commit point for chaos plans), loads are chunk-verified zero-copy mmap
views, and corruption fails with the tensor NAMED.
``save_decoder_checkpoint`` / ``load_decoder_checkpoint`` target the
serving ``DecoderSpec`` / ``decoder_step`` contract so
``load_decoder(checkpoint_dir=...)`` deploys real weights. Sharded
checkpoints (one payload per mesh shard, ``save_sharded_checkpoint`` or
``save_decoder_checkpoint(mesh_axes=, shard_axis=)``) write and load;
a decoder saved with ``mesh_axes`` deploys sharded over that mesh.

    python -m paddle_tpu_torch.checkpoint inspect DIR   # manifest summary
    python -m paddle_tpu_torch.checkpoint verify DIR    # full checksum pass
    python -m paddle_tpu_torch.checkpoint --selftest    # in-process proof
"""
from .decoder import (decoder_checkpoint_mesh, expected_decoder_tensors,
                      load_decoder_checkpoint, save_decoder_checkpoint)
from .errors import CheckpointCorruptError, CheckpointError
from .format import (CheckpointWriter, load_checkpoint_arrays,
                     load_checkpoint_tree, read_manifest,
                     save_checkpoint_tree)
from .sharded import (load_sharded_arrays, load_sharded_checkpoint,
                      save_sharded_checkpoint)

__all__ = [
    "CheckpointError", "CheckpointCorruptError", "CheckpointWriter",
    "save_checkpoint_tree", "load_checkpoint_tree",
    "load_checkpoint_arrays", "read_manifest",
    "save_decoder_checkpoint", "load_decoder_checkpoint",
    "expected_decoder_tensors", "decoder_checkpoint_mesh",
    "save_sharded_checkpoint", "load_sharded_checkpoint",
    "load_sharded_arrays",
]
