"""$GPRMC sentence parsing with XOR checksum validation.

Reproduces NmeaSentenceParser (nmea_sentence_parser.hpp): checksum over the characters between '$' and
'*' (:82-103), degmin -> decimal degrees (:51-55), validity flag 'A'.
"""

import dataclasses


@dataclasses.dataclass
class GPRMC:
    valid: bool = False
    utc: float = 0.0
    latitude: float = 0.0     # decimal degrees, signed by hemisphere
    longitude: float = 0.0
    speed_knots: float = 0.0
    track_deg: float = 0.0
    date: str = ""


def degmin2deg(degmin: float) -> float:
    """ddmm.mmmm -> decimal degrees (nmea_sentence_parser.hpp:51-55)."""
    deg = int(degmin / 100.0)
    minutes = degmin - deg * 100.0
    return deg + minutes / 60.0


class NmeaSentenceParser:
    @staticmethod
    def checksum_ok(sentence: str) -> bool:
        s = sentence.strip()
        if not s.startswith("$") or "*" not in s:
            return False
        body, _, cks = s[1:].partition("*")
        x = 0
        for ch in body:
            x ^= ord(ch)
        try:
            return x == int(cks[:2], 16)
        except ValueError:
            return False

    def parse(self, sentence: str) -> GPRMC:
        out = GPRMC()
        if not self.checksum_ok(sentence):
            return out
        fields = sentence.strip()[1:].split("*")[0].split(",")
        if not fields or not fields[0].endswith("RMC"):
            return out
        try:
            status = fields[2]
            if status != "A":
                return out
            lat = degmin2deg(float(fields[3]))
            if fields[4] == "S":
                lat = -lat
            lon = degmin2deg(float(fields[5]))
            if fields[6] == "W":
                lon = -lon
            out.valid = True
            out.utc = float(fields[1]) if fields[1] else 0.0
            out.latitude = lat
            out.longitude = lon
            out.speed_knots = float(fields[7]) if fields[7] else 0.0
            out.track_deg = float(fields[8]) if fields[8] else 0.0
            out.date = fields[9]
        except (IndexError, ValueError):
            out.valid = False
        return out
