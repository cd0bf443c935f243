"""HPACK of the port (``comm/hpack.py``, RFC 7541): the examples of Appendix
C.2-C.6 with the dynamic table's contents, sizes and evictions after each
block, the Huffman code on every byte value, and the malformed blocks a
decoder must refuse (bad padding, EOS in a string, overlong integers,
indexes past the tables, misplaced or oversized table size updates)."""

import random

import pytest

from distributed_gpu_inference_torch.comm import hpack

# ---------------------------------------------------------------------------
# RFC 7541 Appendix C
# ---------------------------------------------------------------------------

C2 = [
    # C.2.1 literal with indexing
    ("400a637573746f6d2d6b65790d637573746f6d2d686561646572",
     [("custom-key", "custom-header")], [("custom-key", "custom-header")], 55),
    # C.2.2 literal without indexing
    ("040c2f73616d706c652f70617468", [(":path", "/sample/path")], [], 0),
    # C.2.3 literal never indexed
    ("100870617373776f726406736563726574", [("password", "secret")], [], 0),
    # C.2.4 indexed
    ("82", [(":method", "GET")], [], 0),
]

_REQ1 = [(":method", "GET"), (":scheme", "http"), (":path", "/"),
         (":authority", "www.example.com")]
_REQ2 = _REQ1 + [("cache-control", "no-cache")]
_REQ3 = [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
         (":authority", "www.example.com"), ("custom-key", "custom-value")]
_T1 = [(":authority", "www.example.com")]
_T2 = [("cache-control", "no-cache")] + _T1
_T3 = [("custom-key", "custom-value")] + _T2
REQUESTS = [(_REQ1, _T1, 57), (_REQ2, _T2, 110), (_REQ3, _T3, 164)]
C3 = ["828684410f7777772e6578616d706c652e636f6d",
      "828684be58086e6f2d6361636865",
      "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"]
C4 = ["828684418cf1e3c2e5f23a6ba0ab90f4ff",
      "828684be5886a8eb10649cbf",
      "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"]

_D1 = "Mon, 21 Oct 2013 20:13:21 GMT"
_D2 = "Mon, 21 Oct 2013 20:13:22 GMT"
_LOC = "https://www.example.com"
_COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
RESPONSES = [
    ([(":status", "302"), ("cache-control", "private"), ("date", _D1), ("location", _LOC)],
     [("location", _LOC), ("date", _D1), ("cache-control", "private"), (":status", "302")],
     222),
    ([(":status", "307"), ("cache-control", "private"), ("date", _D1), ("location", _LOC)],
     [(":status", "307"), ("location", _LOC), ("date", _D1), ("cache-control", "private")],
     222),
    ([(":status", "200"), ("cache-control", "private"), ("date", _D2), ("location", _LOC),
      ("content-encoding", "gzip"), ("set-cookie", _COOKIE)],
     [("set-cookie", _COOKIE), ("content-encoding", "gzip"), ("date", _D2)],
     215),
]
C5 = [
    "4803333032580770726976617465611d4d6f6e2c203231204f637420323031332032303a31333a323120"
    "474d546e1768747470733a2f2f7777772e6578616d706c652e636f6d",
    "4803333037c1c0bf",
    "88c1611d4d6f6e2c203231204f637420323031332032303a31333a323220474d54c05a04677a6970"
    "7738666f6f3d4153444a4b48514b425a584f5157454f50495541585157454f49553b206d61782d61"
    "67653d333630303b2076657273696f6e3d31",
]
C6 = [
    "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a62d1bff6e919d29ad1718"
    "63c78f0b97c8e9ae82ae43d3",
    "4883640effc1c0bf",
    "88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab77ad94e7821dd7f2e6c7"
    "b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f9587316065c003ed4ee5b1063d5007",
]


@pytest.mark.parametrize("case", range(len(C2)))
def test_rfc7541_c2_single_fields(case):
    block, headers, table, size = C2[case]
    dec = hpack.Decoder()
    assert dec.decode(bytes.fromhex(block)) == headers
    assert list(dec.table.entries) == table and dec.table.size == size


@pytest.mark.parametrize("blocks", [C3, C4], ids=["c3-raw", "c4-huffman"])
def test_rfc7541_requests_share_one_table(blocks):
    dec = hpack.Decoder()
    for block, (headers, table, size) in zip(blocks, REQUESTS):
        assert dec.decode(bytes.fromhex(block)) == headers
        assert list(dec.table.entries) == table and dec.table.size == size


@pytest.mark.parametrize("blocks", [C5, C6], ids=["c5-raw", "c6-huffman"])
def test_rfc7541_responses_evict_at_256_bytes(blocks):
    dec = hpack.Decoder(max_table_size=256)
    dec.table.resize(256)
    for block, (headers, table, size) in zip(blocks, RESPONSES):
        assert dec.decode(bytes.fromhex(block)) == headers
        assert list(dec.table.entries) == table and dec.table.size == size


def test_rfc7541_c4_strings_encode_to_the_rfc_bytes():
    assert hpack.huffman_encode(b"www.example.com").hex() == "f1e3c2e5f23a6ba0ab90f4ff"
    assert hpack.huffman_encode(b"no-cache").hex() == "a8eb10649cbf"
    assert hpack.huffman_encode(_COOKIE.encode()).hex() == C6[2][-90:]


# ---------------------------------------------------------------------------
# Huffman
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("byte", range(256))
def test_huffman_every_byte_round_trips(byte):
    for data in (bytes([byte]), bytes([byte]) * 3, b"a" + bytes([byte]) + b"z"):
        assert hpack.huffman_decode(hpack.huffman_encode(data)) == data


def test_huffman_random_strings_round_trip():
    rng = random.Random(7)
    for n in range(0, 200, 7):
        data = bytes(rng.randrange(256) for _ in range(n))
        enc = hpack.huffman_encode(data)
        assert hpack.huffman_decode(enc) == data
        assert len(enc) == -(-sum(hpack.HUFFMAN_CODES[b][1] for b in data) // 8)


def test_huffman_code_is_complete_and_prefix_free():
    codes = hpack.HUFFMAN_CODES
    assert sum(2.0 ** -n for _, n in codes) == 1.0
    assert codes[hpack.EOS] == ((1 << 30) - 1, 30)
    assert codes[ord("0")] == (0, 5) and codes[0] == (0x1FF8, 13)


@pytest.mark.parametrize("data,why", [
    (bytes([0x18]), "padding is not"),                     # 'a' padded with zeros
    (hpack.huffman_encode(b"a") + b"\xff", "longer than 7"),
    (b"\xff\xff\xff\xfc", "EOS"),                          # 30 ones: EOS
    (b"\xff\xff\xff\xff", "EOS"),
])
def test_huffman_refuses_bad_strings(data, why):
    with pytest.raises(hpack.HPACKError, match=why):
        hpack.huffman_decode(data)


# ---------------------------------------------------------------------------
# integers, indexes, size updates, the encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value,prefix", [(10, 5), (1337, 5), (42, 8), (0, 7), (127, 7),
                                          (2 ** 32, 7), (30, 5), (31, 5)])
def test_prefix_integers_round_trip(value, prefix):
    enc = hpack.encode_int(value, prefix)
    assert hpack.decode_int(memoryview(enc), 0, prefix) == (value, len(enc))


def test_rfc7541_c1_integers():
    assert hpack.encode_int(10, 5) == bytes([0b01010])
    assert hpack.encode_int(1337, 5) == bytes([0b11111, 0b10011010, 0b00001010])
    assert hpack.encode_int(42, 8) == bytes([42])


@pytest.mark.parametrize("block,why", [
    (b"\xff" + b"\x80" * 8 + b"\x01", "longer than the bound"),
    (b"\xff\xff\xff\xff\xff\x7f", "past the bound"),
    (b"\x80", "index 0"),
    (b"\xbe", "past the tables"),                          # 62: an empty dynamic table
    (b"\x3f\xe2\x1f", "past the bound"),                   # size update 4096 + 1
    (b"\x82\x20", "after a field"),
    (b"\x40\x85\xf1\xe3", "past the header block"),        # a string cut short
    (b"\x00\x0a", "past the header block"),
    (b"\xff", "ends inside an integer"),
])
def test_decoder_refuses_malformed_blocks(block, why):
    with pytest.raises(hpack.HPACKError, match=why):
        hpack.Decoder().decode(block)


def test_size_update_evicts_and_zero_empties():
    dec = hpack.Decoder()
    dec.decode(bytes.fromhex(C3[0]))
    dec.decode(bytes.fromhex(C3[1]))
    assert dec.table.size == 110
    dec.decode(b"\x3f\x1f" + b"\x82")              # update to 62: only one entry fits 57
    assert list(dec.table.entries) == [("cache-control", "no-cache")] and dec.table.size == 53
    dec.decode(b"\x20")
    assert not dec.table.entries and dec.table.size == 0


def test_entry_larger_than_the_table_empties_it():
    dec = hpack.Decoder(max_table_size=64)
    dec.decode(bytes.fromhex(C2[0][0]))
    assert dec.table.size == 55
    dec.decode(b"\x40\x01a\x40" + b"v" * 64)
    assert not dec.table.entries and dec.table.size == 0


def test_encoder_blocks_decode_to_the_fields():
    fields = [(":method", "POST"), (":path", "/dgi_tpu.dataplane.v1.PipelineDataPlane/Forward"),
              ("grpc-message", "%0A no é"), ("x-trace-bin", "AAEC"), ("empty", "")]
    enc, dec = hpack.Encoder(), hpack.Decoder()
    assert dec.decode(enc.encode(fields)) == fields
    assert not dec.table.entries                   # literals without indexing
    enc.set_max_table_size(0)
    block = enc.encode(fields)
    assert block[:1] == b"\x20" and dec.decode(block) == fields
