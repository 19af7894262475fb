"""Model families: everything the harness knows about a model's block.

A configuration file (``configs/<config>.json``) names its family under
the required key ``"family"``; ``spec.family(name)`` loads
``families/<name>.py``, as ``spec.traffic_kind`` loads a traffic kind.  No
other file of the harness knows a model's leaves, its pool's layout or
the port's entry points that serve it, so a new architecture is a new
family file, its plain reference under ``reference/``, a configuration
naming it and entries in ``BENCHMARK.json``.

A family file defines:

``shape(config)``
    The sizes of a configuration, as an object whose cost functions
    ``mfu.py`` calls, all from shapes alone and built on ``roofline.py``'s
    primitives (``causal_pairs``, ``prefill_attention``, ``paged_decode``,
    ``Cost``):

    - ``prefill_flops(prefix, new)``: model FLOPs of a prefill of ``new``
      tokens after ``prefix`` cached ones: every new token's matrix
      products and causal attention, and the output head for the last
      position only (FLOPs).
    - ``decode_flops(contexts)``: model FLOPs of one decode step over live
      rows with the given context lengths, the current token included;
      each row's matrix products, attention and output head (FLOPs).
    - ``prefill_attention_bound_s(prefix, new, peaks)``: the least time
      the prefill attention kernel's calls of such a prefill could take,
      summed over the layers (seconds; ``peaks`` as ``roofline.PEAKS``).
    - ``decode_attention_bound_s(contexts, kv_tokens, peaks)``: the same
      for the decode kernel's calls of one step; ``kv_tokens`` is the
      count of distinct pool slots the rows read, or None where each
      row's context counts (seconds).

    A family with layers of several kinds sums each bound by kind.

``weights(config, seed, device)``
    The params tree, drawn from ``seed`` on ``device`` in the served type
    (``weights.Draw``); the program and the reference are both handed it.

``model(config, mix)``
    What the serving loop calls, at the mix's block size (``"multiple"``):

    - ``block_size`` (tokens a pool block holds), ``vocab_size``;
    - ``pool(blocks, device)``: the KV pool, an object whose ``.kv`` the
      entry points take; block 0 is the pad rows' scratch block;
    - ``block_bytes``: the device bytes one pool block id holds over all
      layers (bytes);
    - ``graph_bytes(buckets)``: what the decode graphs of these batch
      buckets keep in their private pools (bytes);
    - ``prefill_paged(params, tokens, kv, table)`` and
      ``prefill_continue(params, tokens, kv, table, prefix_len)``: tokens
      ``[1, T]`` int64, the block table ``[1, blocks]`` int32; each
      returns ``(logits [1, T, vocab], kv)`` and writes the new tokens'
      K/V into the pool;
    - ``make_decode_step(params, kv, batch, width)``: a callable
      ``step(tokens [batch], table [batch, width], contexts [batch])``
      returning logits ``[batch, vocab]``, the token's K/V written.

``reference_logits(params, config, tokens, first, quant=None)``
    Float32 logits ``[len(tokens) - first, vocab]`` at positions
    ``first ..`` of ``tokens`` (int64, on the weights' device), from the
    family's plain reference under ``reference/``, which imports nothing
    of the port or the harness; ``quant="fp8"`` is the control.
"""
