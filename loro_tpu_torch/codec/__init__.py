"""The port's copy of the wire codec it needs: the payload prelude reader
and an encoder for text traces (codec/binary.py)."""
