"""The journal follow API (``persistence.journal.tail``) of the port
against the JAX package's, on the CPU.

Every case of the reference's ``tests/test_journal_tail.py`` runs on both
packages (``m`` is either one's names) and holds each to that test's
expectations: a torn tail in the active segment holds (and the record is
returned once whole), a sealed segment's corruption abandons the rest of
that segment only, rotation and compaction are followed, and a bounded call
resumes exactly where it stopped.  ``tests/test_torch_persistence.py``
holds the two packages' positions equal step by step.
"""

import os
import struct
import zlib

import pytest

from llm_d_kv_cache_manager_tpu.kvcache.kvblock import index as ref_index
from llm_d_kv_cache_manager_tpu.persistence import journal as ref_journal
from tests.helpers.torch_port import namespace

SIDES = ("ref", "port")
_REF = {
    "kvcache.kvblock.index": ref_index,
    "persistence.journal": ref_journal,
}
_NAMES = {
    "kvcache.kvblock.index": ("PodEntry",),
    "persistence.journal": ("OP_ADD", "OP_PURGE", "Journal", "JournalRecord", "TailPosition",
                            "list_segments", "tail"),
}


def mods(side):
    m = namespace(side, _REF, _NAMES)
    m.POD = m.PodEntry("pod-a", "hbm")
    return m


@pytest.fixture(params=SIDES)
def m(request):
    return mods(request.param)


_RECORD_HEADER = struct.Struct(">II")


def _record(m, i: int, seq: int = 0):
    return m.JournalRecord(
        op=m.OP_ADD,
        pod_identifier="pod-a",
        seq=seq,
        ts_ns=1,
        engine_keys=[1000 + i],
        request_keys=[2000 + i],
        entries=[m.POD],
    )


def _frame(m, record) -> bytes:
    body = record.encode()
    return (
        _RECORD_HEADER.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF)
        + body
    )


def _append_raw(m, directory: str, data: bytes) -> str:
    """Append bytes to the newest segment file directly (simulating a
    writer whose append is partially visible)."""
    segments = m.list_segments(directory)
    path = segments[-1][1]
    with open(path, "ab") as handle:
        handle.write(data)
    return path


class TestTailBasics:
    def test_follow_from_start_and_resume(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 1, [1], [2], [m.POD])
        journal.record_add("pod-a", 2, [3], [4], [m.POD])

        records, position = m.tail(str(tmp_path))
        assert [r.seq for r in records] == [1, 2]

        journal.record_evict("pod-a", 3, [1], [m.POD])
        more, position2 = m.tail(str(tmp_path), position)
        assert len(more) == 1 and more[0].seq == 3
        # Idle poll: nothing new, position stable.
        empty, position3 = m.tail(str(tmp_path), position2)
        assert empty == [] and position3 == position2
        journal.close()

    def test_empty_directory(self, m, tmp_path):
        records, position = m.tail(str(tmp_path))
        assert records == [] and position == m.TailPosition(0, 0)

    def test_boundary_start_skips_covered_segments(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 1, [1], [2], [m.POD])
        boundary, watermarks, _ = journal.snapshot_boundary()
        journal.record_add("pod-a", 2, [3], [4], [m.POD])

        records, _ = m.tail(str(tmp_path), m.TailPosition(boundary, 0))
        assert [r.seq for r in records] == [2]
        assert watermarks == {"pod-a": 1}
        journal.close()

    def test_max_records_resumes_mid_segment(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        for i in range(5):
            journal.record_add("pod-a", i + 1, [i], [i], [m.POD])
        first, position = m.tail(str(tmp_path), max_records=2)
        assert [r.seq for r in first] == [1, 2]
        rest, _ = m.tail(str(tmp_path), position)
        assert [r.seq for r in rest] == [3, 4, 5]
        journal.close()

    def test_purge_records_flow_through(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 1, [1], [2], [m.POD])
        journal.record_purge("pod-a")
        records, _ = m.tail(str(tmp_path))
        assert [r.op for r in records] == [m.OP_ADD, m.OP_PURGE]
        assert records[1].pod_identifier == "pod-a"
        journal.close()


class TestTornTails:
    def test_active_torn_tail_holds_then_completes(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 1, [1], [2], [m.POD])
        journal.close()

        frame = _frame(m, _record(m, 7))
        _append_raw(m, str(tmp_path), frame[: len(frame) - 5])

        records, position = m.tail(str(tmp_path))
        assert len(records) == 1  # the whole record only
        held = position

        # Writer finishes the append: the SAME position now yields it.
        _append_raw(m, str(tmp_path), frame[len(frame) - 5:])
        more, position2 = m.tail(str(tmp_path), held)
        assert len(more) == 1
        assert more[0].engine_keys == [1007]
        assert position2.offset > held.offset

    def test_crc_corruption_in_active_segment_holds(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 1, [1], [2], [m.POD])
        journal.close()
        frame = bytearray(_frame(m, _record(m, 8)))
        frame[-1] ^= 0xFF  # body corrupted, CRC now mismatches
        _append_raw(m, str(tmp_path), bytes(frame))

        records, position = m.tail(str(tmp_path))
        assert len(records) == 1
        again, position2 = m.tail(str(tmp_path), position)
        assert again == [] and position2 == position

    def test_sealed_torn_tail_abandons_segment(self, m, tmp_path):
        """A higher-id segment exists: the torn record can never
        complete, so the follower moves on (stop-don't-skip applies to
        the REST of the sealed segment, not the whole journal)."""
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 1, [1], [2], [m.POD])
        journal.close()
        frame = _frame(m, _record(m, 9))
        _append_raw(m, str(tmp_path), frame[: len(frame) - 3])

        # A fresh Journal seals the torn segment by starting a new one.
        journal2 = m.Journal(str(tmp_path))
        journal2.record_add("pod-a", 2, [5], [6], [m.POD])

        records, position = m.tail(str(tmp_path))
        assert [r.seq for r in records] == [1, 2]
        # Cursor sits in the NEW segment now.
        assert position.segment_id == m.list_segments(str(tmp_path))[-1][0]
        journal2.close()

    def test_undecodable_but_whole_record_is_skipped(self, m, tmp_path):
        journal = m.Journal(str(tmp_path))
        journal.record_add("pod-a", 1, [1], [2], [m.POD])
        journal.close()
        body = b"\x00"  # valid CBOR int, wrong record shape
        _append_raw(m,
            str(tmp_path),
            _RECORD_HEADER.pack(len(body), zlib.crc32(body) & 0xFFFFFFFF)
            + body,
        )
        _append_raw(m, str(tmp_path), _frame(m, _record(m, 3, seq=2)))
        records, _ = m.tail(str(tmp_path))
        # The garbage record is skipped (it will never change); the
        # good one behind it still arrives.
        assert [r.seq for r in records] == [1, 2]


class TestRotationAndCompaction:
    def test_rotation_mid_follow(self, m, tmp_path):
        journal = m.Journal(str(tmp_path), segment_max_bytes=1)
        journal.record_add("pod-a", 1, [1], [2], [m.POD])
        records, position = m.tail(str(tmp_path))
        assert len(records) == 1
        # Every append rotates at this size: new records land in new
        # segment files; the cursor follows.
        journal.record_add("pod-a", 2, [3], [4], [m.POD])
        journal.record_add("pod-a", 3, [5], [6], [m.POD])
        more, position2 = m.tail(str(tmp_path), position)
        assert [r.seq for r in more] == [2, 3]
        assert position2.segment_id > position.segment_id
        journal.close()

    def test_compaction_of_cursor_segment_jumps_forward(self, m, tmp_path):
        journal = m.Journal(str(tmp_path), segment_max_bytes=1)
        journal.record_add("pod-a", 1, [1], [2], [m.POD])
        _, position = m.tail(str(tmp_path))
        journal.record_add("pod-a", 2, [3], [4], [m.POD])
        # Compact everything below the newest segment — including the
        # segment the cursor points into.
        newest = m.list_segments(str(tmp_path))[-1][0]
        removed = journal.compact_before(newest)
        assert removed >= 1
        records, position2 = m.tail(str(tmp_path), position)
        assert [r.seq for r in records] == [2]
        assert position2.segment_id >= newest
        journal.close()

    def test_gap_in_segment_ids_is_followed(self, m, tmp_path):
        journal = m.Journal(str(tmp_path), segment_max_bytes=1)
        for seq in (1, 2, 3):
            journal.record_add("pod-a", seq, [seq], [seq], [m.POD])
        segments = m.list_segments(str(tmp_path))
        # Remove a MIDDLE segment (manual compaction hole).
        os.unlink(segments[1][1])
        records, _ = m.tail(str(tmp_path))
        assert [r.seq for r in records] == [1, 3]
        journal.close()
