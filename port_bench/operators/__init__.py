"""The operators a configuration can name (its ``"operator"`` key), one module each, built on the
device in the format the configuration names (its ``"format"`` key, a row of ``harness.FORMATS``).
The module gives that format's function, ``(params, dtype, device)``, and the harness hands what it
returns to the port's constructor as it comes:

- ``dia``: ``bands`` → ``(bands, offsets, shape)``, row-aligned (``bands[d, i] = A[i, i + offsets[d]]``)
  with ascending offsets, for ``DIAOperator``;
- ``bsr``: ``tiles`` → ``(blocks, indices, indptr, shape)``, ``(nnzb, bm, bn)`` tiles, each block
  row's tiles sorted by block column, for ``BSROperator``;
- ``csr``: ``entries`` → ``(data, indices, indptr, shape)``, each row's columns sorted, no
  duplicates, for ``CSROperator``.

The reference of the same kind (``reference/<kind>.py``) applies the operator from its law instead.
"""
