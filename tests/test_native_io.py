"""Native (C++) FASTA reader vs. the Python reader — identical buffers."""

import numpy as np
import pytest

from krisp_tpu.io.fasta import read_fasta_buffer
from krisp_tpu.io.native import read_fasta_buffer_native, get_lib


def test_native_reader_matches_python(tmp_path):
    if get_lib() is None:
        pytest.skip("native toolchain unavailable")
    fa = tmp_path / "g.fasta"
    fa.write_text(">r1 desc\nACGTacgt\nNNGG\n>r2\nTTTT\n")
    want, _ = read_fasta_buffer(str(fa))
    got = read_fasta_buffer_native(str(fa))
    assert got is not None
    np.testing.assert_array_equal(got, want)


def test_native_reader_gz(tmp_path, planted_fasta):
    import gzip

    if get_lib() is None:
        pytest.skip("native toolchain unavailable")
    path = str(tmp_path / "ingroup0.fasta.gz")
    with open(planted_fasta()[0][0], "rb") as src, \
            gzip.open(path, "wb") as dst:
        dst.write(src.read())
    want, _ = read_fasta_buffer(path)
    got = read_fasta_buffer_native(path)
    np.testing.assert_array_equal(got, want)
