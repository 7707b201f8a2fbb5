"""Bitstream header and .bin container (ref: src/utils/codec_utils.py).

Header: H, W as uint16 LE; a format byte; quality byte. The compressai
stream format keeps the reference's exact 6-byte layout (byte 5 =
max(|y_hat|), written for format parity, unused on decode). The tpu
stream format (ours) appends a uint16 encode-batch field (8 bytes total);
legacy 6-byte tpu headers from earlier rounds still parse (encode_batch
reported as None).

Quality byte bit 7 marks the device-coded 'tpu' stream format; bit 6
marks a PORTABLE stream — one whose entropy parameters were derived
through canonical per-image (batch-1) executables, so any decoder batch
grouping reproduces them (codec/driver.py portable mode). Bits 0-5 are
the quality index. Reference-produced streams have bits 6-7 clear and
parse as non-portable compressai streams.

Container: for each of [header, z_string, y_string], a uint32 LE length
followed by the raw bytes.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple


class HeaderHandler:
    SIZE = 6  # compressai-format header size (reference parity)

    @staticmethod
    def encode(img_size: Tuple[int, int], max_abs_y: int, quality_ind: int,
               tpu_format: bool = False, lanes: int = 128,
               esc_dense: bool = False, portable: bool = False,
               encode_batch: int = 0, t2free: bool = False,
               fast_entropy: bool = False, bf16: bool = False,
               escfree: bool = False) -> bytes:
        """quality byte bit 7 marks the device-coded 'tpu' stream format
        (ops/rans_device.py), bit 6 the portable-stream mode; bits 0-5 are
        the quality index. For the tpu format the third byte carries log2
        of the interleave-lane cap in bits 0-5; bit 7 is the dense-escape
        flag: set when some section has more escapes than
        ops/rans_device.esc_cap() so the decoder must use the dense
        (uncapped) escape epilogue; bit 6 is the tier-2-free GUARANTEE: the
        encoder certifies no escape spilled past its tier-1 word, so the
        decoder may drop the tier-2 resolution from the escape epilogue
        (decode_section tier2=False — a big win on escape-heavy streams;
        rounds <= 4 wrote the bit as 0, which decodes conservatively). Two
        trailing bytes record the encode batch size (the executable-lowering
        coupling a NON-portable decode must match — driver.py; 0 = unknown).
        A ninth byte records the codec numeric configuration the stream
        bytes depend on — bit 0: fast entropy-parameter convs
        (entropy_precision != 'high'), bit 1: bf16 conv stacks
        (codec_dtype == 'bfloat16') — so a decoder built with the other
        setting fails fast (driver.py) instead of silently desyncing.
        Bit 2 is the ESCAPE-FREE guarantee: the encoder's exact escape
        counts certify this image's stream contains no escapes at all, so
        the decoder may skip the entire escape epilogue (decode_section
        escfree=True — deletes the rank->raw rebuild gather and the
        full-plane escape cumsum per section; a violation poisons the
        consumed-words cursor). Bits 3-7 reserved (written 0). Legacy
        <=8-byte headers from rounds <= 4 parse with these as unknown and
        decode conservatively.
        (The reference writes max|y_hat| in byte 5 and never reads it back,
        src/utils/codec_utils.py)."""
        H, W = img_size
        if not 0 <= int(quality_ind) < 64:
            raise ValueError(
                f"quality_ind {quality_ind} out of range [0, 64): bits 6-7 "
                "of the quality byte are the portable/stream-format flags")
        if tpu_format and int(lanes).bit_length() - 1 > 0x3F:
            raise ValueError(f"lane cap {lanes} exceeds the header field")
        qb = (int(quality_ind) | (0x80 if tpu_format else 0)
              | (0x40 if portable else 0))
        b3 = ((int(lanes).bit_length() - 1) | (0x80 if esc_dense else 0)
              | (0x40 if t2free else 0)
              if tpu_format else min(255, max(0, int(max_abs_y))))
        head = struct.pack("<HHBB", H, W, b3, qb)
        if tpu_format:
            head += struct.pack("<H", min(0xFFFF, max(0, int(encode_batch))))
            head += struct.pack(
                "<B", (1 if fast_entropy else 0) | (2 if bf16 else 0)
                | (4 if escfree else 0))
        return head

    @staticmethod
    def decode(header: bytes) -> Dict:
        H, W, b3, qb = struct.unpack("<HHBB", header[:6])
        tpu = bool(qb & 0x80)
        enc_b = None
        fast_entropy = bf16 = escfree = None
        if tpu and len(header) >= 8:
            (enc_b,) = struct.unpack("<H", header[6:8])
        if tpu and len(header) >= 9:
            cfg = header[8]
            fast_entropy = bool(cfg & 1)
            bf16 = bool(cfg & 2)
            escfree = bool(cfg & 4)
        return {"img_size": (H, W),
                "fast_entropy": fast_entropy,
                "bf16": bf16,
                "escfree": escfree,
                "max_sample": None if tpu else b3,
                "lanes": (1 << (b3 & 0x3F)) if tpu else None,
                "esc_dense": bool(b3 & 0x80) if tpu else None,
                # rounds <= 4 wrote bit 6 as 0 (lane log2 <= 7 never reached
                # it), so legacy streams parse as "no guarantee" and decode
                # through the conservative tier-2-resolving epilogue
                "t2free": bool(b3 & 0x40) if tpu else None,
                "quality_ind": qb & 0x3F,
                "portable": bool(qb & 0x40),
                "encode_batch": enc_b,
                "stream_format": "tpu" if tpu else "compressai"}


def save_byte_strings(path: str, strings: List[bytes]) -> None:
    with open(path, "wb") as f:
        for s in strings:
            f.write(struct.pack("<I", len(s)))
            f.write(s)


def load_byte_strings(path: str) -> List[bytes]:
    out = []
    with open(path, "rb") as f:
        while True:
            head = f.read(4)
            if not head:
                break
            (n,) = struct.unpack("<I", head)
            out.append(f.read(n))
    return out
