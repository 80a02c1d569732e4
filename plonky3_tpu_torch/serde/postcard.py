"""Postcard wire-format primitives (LEB128 varints + positional structs).

Port of `plonky3_tpu/serde/postcard.py` (plain Python).

The reference's golden proof fixtures are `postcard`-encoded
(`uni-stark/tests/fib_air.rs:131-132`). Postcard is a non-self-describing
serde format: unsigned ints are LEB128 varints, structs/tuples/fixed arrays
are field concatenations, `Vec` is a varint length followed by elements,
`Option` is a 0/1 tag byte, `u8` is one raw byte.

Field elements serialize in **Monty form** for Monty fields
(`monty-31/src/monty_31.rs:167-184`, `serialize_u32`), as canonical u32 for
Mersenne31, and as `[u64; N]`/`[u8; N]` digests for keccak configs.
"""

from __future__ import annotations


class Reader:
    """Sequential postcard decoder over a bytes buffer."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def u8(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        """Unsigned LEB128 (postcard's u16/u32/u64/usize encoding)."""
        out = 0
        shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def bytes(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("postcard: out of data")
        self.pos += n
        return out

    def bool(self) -> bool:
        b = self.u8()
        if b > 1:
            raise ValueError(f"postcard: invalid bool byte {b}")
        return bool(b)

    def option(self, parse):
        tag = self.u8()
        if tag == 0:
            return None
        if tag != 1:
            raise ValueError(f"postcard: invalid Option tag {tag}")
        return parse()

    def vec(self, parse) -> list:
        n = self.varint()
        return [parse() for _ in range(n)]

    def array(self, parse, n: int) -> tuple:
        return tuple(parse() for _ in range(n))


class Writer:
    """Sequential postcard encoder."""

    def __init__(self):
        self.buf = bytearray()

    def getvalue(self) -> bytes:
        return bytes(self.buf)

    def u8(self, v: int):
        self.buf.append(v & 0xFF)

    def varint(self, v: int):
        if v < 0:
            raise ValueError("postcard: negative varint")
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.buf.append(b | 0x80)
            else:
                self.buf.append(b)
                return

    def bytes(self, b: bytes):
        self.buf.extend(b)

    def bool(self, v: bool):
        self.buf.append(1 if v else 0)

    def option(self, v, write):
        if v is None:
            self.buf.append(0)
        else:
            self.buf.append(1)
            write(v)

    def vec(self, items, write):
        self.varint(len(items))
        for it in items:
            write(it)
