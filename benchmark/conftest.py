"""Completes ``tests/test_rehearsal.TINY``, the table of each
configuration's tiny stand-in for the CPU rehearsal of its cells, with the
configurations added after that table, so that every cell's rehearsal finds
its stand-in whichever test modules pytest collects."""

from benchmark.tests import test_rehearsal

test_rehearsal.TINY.setdefault("granite-4.0-h-micro.zonos-int8", "tiny-granite.json")
