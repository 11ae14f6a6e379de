"""The production loop's shared pieces, as far as the port has them:

- :mod:`easydl_tpu_torch.loop.spool` — the spool's framing and segment
  core, which the PS write-ahead log is built on;
- :mod:`easydl_tpu_torch.loop.publish` — dense models published as
  immutable versioned artifacts (manifest + CRC, ``COMMITTED`` marker
  last, quarantine on corruption, one-file rollback), and the
  serve-side :class:`~easydl_tpu_torch.loop.publish.ModelVersionWatcher`
  that hot-swaps a replica's forward between batches;
- :mod:`easydl_tpu_torch.loop.rollout` — the pure rollout policy:
  session-to-arm assignment and canary pacing.

The feedback stream and ``train_continuous`` are ROADMAP Queue A 5b."""
