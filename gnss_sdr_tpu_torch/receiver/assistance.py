# Copied from gnss_sdr_tpu/receiver/assistance.py; only the package imports are rewritten.
"""Assistance persistence: ephemeris / iono-UTC / almanac save & reload.

Reference: ControlThread::read_assistance_from_XML + the on-exit XML save
(control_thread.cc:515-600, gnss_sdr_supl_client.h) — warm/hot starts skip
the 18-30 s of live ephemeris decoding, cutting TTFF to the first anchored
subframe.  The reference writes boost::serialization XML; here the schema
is a plain field dump (same information, readable, versioned).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import fields
from pathlib import Path

from gnss_sdr_tpu_torch.telemetry.inav import GalileoEphemeris
from gnss_sdr_tpu_torch.telemetry.lnav import GpsAlmanac, GpsEphemeris, GpsIonoUtc
from gnss_sdr_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

_CLASSES = {"G": GpsEphemeris, "E": GalileoEphemeris}


def _obj_to_elem(tag: str, obj) -> ET.Element:
    el = ET.Element(tag)
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, (int, float, bool, str)):
            ET.SubElement(el, f.name).text = repr(v)
    return el


def _elem_to_obj(el: ET.Element, cls):
    obj = cls()
    for child in el:
        if not hasattr(obj, child.tag):
            continue
        cur = getattr(obj, child.tag)
        txt = child.text or ""
        if isinstance(cur, bool):
            setattr(obj, child.tag, txt == "True")
        elif isinstance(cur, int):
            setattr(obj, child.tag, int(float(txt)))
        elif isinstance(cur, float):
            setattr(obj, child.tag, float(txt))
        elif isinstance(cur, str):
            setattr(obj, child.tag, txt.strip("'\""))
    return obj


def save_assistance(
    path: str | Path,
    ephemerides: dict,                 # (system, prn) -> ephemeris
    iono_utc: GpsIonoUtc | None = None,
    almanacs: dict[int, GpsAlmanac] | None = None,
) -> None:
    root = ET.Element("gnss_assistance", version="1")
    for (sysid, prn), eph in sorted(ephemerides.items()):
        el = _obj_to_elem("ephemeris", eph)
        el.set("system", sysid)
        el.set("prn", str(prn))
        root.append(el)
    if iono_utc is not None:
        root.append(_obj_to_elem("iono_utc", iono_utc))
    for prn, alm in sorted((almanacs or {}).items()):
        el = _obj_to_elem("almanac", alm)
        el.set("prn", str(prn))
        root.append(el)
    ET.indent(root)
    Path(path).write_bytes(ET.tostring(root, xml_declaration=True))
    log.info("assistance saved: %d ephemerides -> %s",
             len(ephemerides), path)


def load_assistance(path: str | Path) -> dict:
    """Returns {'ephemerides': {(sys, prn): eph}, 'iono_utc': ..,
    'almanacs': {prn: alm}} (missing sections empty/None)."""
    root = ET.parse(str(path)).getroot()
    out = {"ephemerides": {}, "iono_utc": None, "almanacs": {}}
    for el in root:
        if el.tag == "ephemeris":
            sysid = el.get("system", "G")
            cls = _CLASSES.get(sysid, GpsEphemeris)
            eph = _elem_to_obj(el, cls)
            out["ephemerides"][(sysid, int(el.get("prn", "0")))] = eph
        elif el.tag == "iono_utc":
            out["iono_utc"] = _elem_to_obj(el, GpsIonoUtc)
        elif el.tag == "almanac":
            alm = _elem_to_obj(el, GpsAlmanac)
            out["almanacs"][int(el.get("prn", "0"))] = alm
    log.info("assistance loaded: %d ephemerides from %s",
             len(out["ephemerides"]), path)
    return out


# -------------------------------------------------- observables map XML
def save_gnss_synchro_map_xml(path: str | Path, synchro_map: dict) -> None:
    """Persist one epoch's per-channel GnssSynchro map to XML.

    Reference analog: rtklib_pvt_gs save_gnss_synchro_map_xml
    (rtklib_pvt_gs.cc:1716) — a boost::serialization dump of the
    observables map, used to can epochs for offline solver tests.
    ``synchro_map`` is {channel_id: GnssSynchro}.
    """
    root = ET.Element("gnss_synchro_map", version="1")
    for ch, s in sorted(synchro_map.items()):
        el = _obj_to_elem("synchro", s)
        el.set("channel", str(ch))
        root.append(el)
    ET.ElementTree(root).write(path, encoding="unicode")
    log.info("saved %d GnssSynchro records to %s", len(synchro_map), path)


def load_gnss_synchro_map_xml(path: str | Path) -> dict:
    """Reload a canned observables epoch
    (rtklib_pvt_gs.cc:1758 load_gnss_synchro_map_xml analog)."""
    from gnss_sdr_tpu_torch.monitor.synchro import GnssSynchro

    root = ET.parse(path).getroot()
    out = {}
    for el in root.iter("synchro"):
        s = _elem_to_obj(el, GnssSynchro)
        out[int(el.get("channel", s.channel_id))] = s
    return out
