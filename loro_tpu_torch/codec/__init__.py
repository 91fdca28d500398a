"""The port's copy of the wire codec (codec/binary.py): the payload
decoder and an encoder for text traces."""
