"""Metrics for the crash-consistency layer: the write-ahead intent
journal (runtime/journal.py) and the startup recovery controller
(controllers/recovery.py). The JAX package's family letter for letter;
``watch_relist_total`` is registered with it and moves only where a
kube client relists (the port's in-memory store never does).

Series on the process registry (``karpenter_`` prefix via
registry.expose()):

- ``karpenter_journal_records_total``       counter, ``kind`` label —
  intent records appended to the write-ahead journal, by intent kind
- ``karpenter_journal_bytes_total``         counter — bytes appended to
  journal segments (CRC frame + payload + newline)
- ``karpenter_journal_append_seconds``      histogram — wall seconds of
  one durable append (serialize + write + fsync), the bind-path tax
- ``karpenter_journal_open_intents``        gauge — intents currently
  open (not yet closed) in the journal's live index
- ``karpenter_journal_segments``            gauge — journal segment
  files on disk
- ``karpenter_journal_compactions_total``   counter — segment
  compactions (closed intents dropped, segments rewritten)
- ``karpenter_journal_torn_records_total``  counter — records discarded
  on replay (torn tail or CRC mismatch)
- ``karpenter_recovery_intents_total``      counter, ``kind``/``action``
  labels — open intents resolved by startup recovery: action is
  ``forward`` (rolled forward), ``rollback`` (unwound/terminated), or
  ``noop`` (already converged)
- ``karpenter_recovery_seconds``            histogram — wall seconds of
  one full journal replay (readyz stays 503 ``recovering`` meanwhile)
- ``karpenter_ledger_recovery_seconds``     histogram — wall seconds
  spent rebuilding the topology occupancy ledger from open carve
  intents during one journal replay (a slice of recovery_seconds)
- ``karpenter_ledger_recovered_carves_total``  counter — carve records
  re-committed into the occupancy ledger by startup recovery
- ``karpenter_watch_relist_total``          counter, ``kind``/``reason``
  labels — full relist-and-reconcile passes a watch performed after a
  gap (``expired`` = resourceVersion too old / 410, ``reconnect`` =
  stream ended or errored)
"""

from __future__ import annotations

from karpenter_tpu_torch.metrics.registry import DEFAULT

JOURNAL_RECORDS_TOTAL = DEFAULT.counter(
    "journal_records_total",
    "Intent records appended to the write-ahead journal, by intent kind")

JOURNAL_BYTES_TOTAL = DEFAULT.counter(
    "journal_bytes_total",
    "Bytes appended to write-ahead journal segments")

JOURNAL_APPEND_SECONDS = DEFAULT.histogram(
    "journal_append_seconds",
    "Wall seconds of one durable journal append (serialize+write+fsync)")

JOURNAL_OPEN_INTENTS = DEFAULT.gauge(
    "journal_open_intents",
    "Intents currently open in the journal's live index")

JOURNAL_SEGMENTS = DEFAULT.gauge(
    "journal_segments",
    "Write-ahead journal segment files on disk")

JOURNAL_COMPACTIONS_TOTAL = DEFAULT.counter(
    "journal_compactions_total",
    "Journal segment compactions (closed intents dropped)")

JOURNAL_TORN_RECORDS_TOTAL = DEFAULT.counter(
    "journal_torn_records_total",
    "Journal records discarded on replay (torn tail or CRC mismatch)")

RECOVERY_INTENTS_TOTAL = DEFAULT.counter(
    "recovery_intents_total",
    "Open intents resolved by startup recovery, by kind and action "
    "(forward | rollback | noop)")

RECOVERY_SECONDS = DEFAULT.histogram(
    "recovery_seconds",
    "Wall seconds of one full journal replay at startup")

LEDGER_RECOVERY_SECONDS = DEFAULT.histogram(
    "ledger_recovery_seconds",
    "Wall seconds rebuilding the occupancy ledger from open carve "
    "intents during startup recovery")

LEDGER_RECOVERED_CARVES_TOTAL = DEFAULT.counter(
    "ledger_recovered_carves_total",
    "Carve records re-committed into the occupancy ledger by recovery")

WATCH_RELIST_TOTAL = DEFAULT.counter(
    "watch_relist_total",
    "Full relist-and-reconcile passes performed by a watch after a gap, "
    "by kind and reason (expired | reconnect)")
