"""platanus3_tpu_torch: the PyTorch + CUDA port of platanus3_tpu.

Same assembler, same stage boundaries and the same array layouts as the
JAX package (``platanus3_tpu``), which stays the reference: every module
here keeps its counterpart's name and public function names.  Tensors
live on an explicit device (``assemble`` defaults to the card); on a CUDA
device each of the JAX package's Pallas kernels is a hand-written Hopper
kernel in ``csrc/``: the packed and the blocked Bloom builds
(``bloom.cu``) and the open-addressing k-mer counter (``count_oa.cu``).

Conventions shared by every module:

* k-mer lanes keep the JAX layout ``[..., L]`` (MSB-first, low-aligned),
  stored as ``int64`` tensors holding the ``uint32`` lane values (torch's
  ``uint32`` has no shifts, compares or scatters on the CPU build);
* hashing is done in ``int64``, masked to 32 bits after every wrapping
  multiply, so hash values are bit-equal to the JAX package's;
* Bloom filter words are ``int32`` tensors holding the ``uint32`` word
  bit patterns (bit ``p`` is bit ``p & 31`` of word ``p >> 5``).

Ported: single-shot ``pipeline.assemble`` at any k, in exact or Bloom
membership, with simplification and checkpoints; ``graph/multik``;
``streaming.assemble_streaming``; ``sweep.solid_threshold_sweep``; the C++
read loader (``native/``); ``torch.profiler`` traces; the CLI; and the
entry points of the other two kernels (``ops/count_oa``,
``ops/bloom_blocked``); and sharding over ranks of ``torch.distributed``
(``parallel/``: the sharded stage 1, streaming and multi-k over a mesh,
``--mesh`` and the multi-process helpers).
"""

__version__ = "0.1.0"

from platanus3_tpu_torch.config import AssemblyConfig

__all__ = ["AssemblyConfig"]
