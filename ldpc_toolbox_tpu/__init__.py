"""ldpc_toolbox_tpu — an LDPC codec framework on JAX.

A from-scratch JAX/XLA framework with the capability surface of the
Rust crate ``ldpc-toolbox`` (SURVEY.md): sparse
parity-check construction (MacKay-Neal, PEG, CCSDS AR4JA/C2, DVB-S2, 5G NR),
alist interchange, girth analysis, systematic encoding, belief-propagation
decoding (flooding + horizontal-layered schedules across 18 arithmetic
rules), and a batched Monte-Carlo AWGN BER harness.

Architecture (batched tensor code, not a port):

* Graph construction and GF(2) linear algebra live on the host (numpy) —
  they run once per code and are not tensor math.
* Decoding operates on a *padded dual-gather layout* (`decoder.layout`):
  messages are dense ``(edges, batch)`` arrays in device memory; check and
  variable updates are two static gathers per iteration — no scatters —
  vectorized over large codeword batches. Lifted (block-circulant) codes
  take `decoder.lifted_*`, which move whole ``(Z, batch)`` planes.
* The BER harness is a single jitted step over a batch of frames; batches
  shard over a `jax.sharding.Mesh` and error counters reduce with XLA
  collectives.
"""

__version__ = "0.1.0"

from .sparse import SparseMatrix, Node, BFSResults  # noqa: F401
