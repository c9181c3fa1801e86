"""JPEG marker byte constants (ITU-T T.81 Table B.1).

Capability parity with reference jpeg/model/src/marker_code.ml.
"""

# Start-of-frame markers, non-differential, Huffman coding
SOF0 = 0xC0  # Baseline DCT
SOF1 = 0xC1  # Extended sequential DCT
SOF2 = 0xC2  # Progressive DCT
SOF3 = 0xC3  # Lossless (sequential)
# Differential, Huffman coding
SOF5 = 0xC5
SOF6 = 0xC6
SOF7 = 0xC7
# Non-differential, arithmetic coding
JPG = 0xC8
SOF9 = 0xC9
SOF10 = 0xCA
SOF11 = 0xCB
# Differential, arithmetic coding
SOF13 = 0xCD
SOF14 = 0xCE
SOF15 = 0xCF

DHT = 0xC4  # Define Huffman table(s)
DAC = 0xCC  # Define arithmetic coding conditioning(s)

# Restart interval termination
RST0 = 0xD0
RST1 = 0xD1
RST2 = 0xD2
RST3 = 0xD3
RST4 = 0xD4
RST5 = 0xD5
RST6 = 0xD6
RST7 = 0xD7

SOI = 0xD8  # Start of image
EOI = 0xD9  # End of image
SOS = 0xDA  # Start of scan
DQT = 0xDB  # Define quantization table(s)
DNL = 0xDC  # Define number of lines
DRI = 0xDD  # Define restart interval
DHP = 0xDE  # Define hierarchical progression
EXP = 0xDF  # Expand reference component(s)

APP0 = 0xE0
APP15 = 0xEF

JPG0 = 0xF0
JPG13 = 0xFD
COM = 0xFE  # Comment

TEM = 0x01  # Temporary private use in arithmetic coding


def is_rst(code: int) -> bool:
    return RST0 <= code <= RST7


def is_app(code: int) -> bool:
    return APP0 <= code <= APP15
