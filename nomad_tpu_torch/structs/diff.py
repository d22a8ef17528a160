"""Structural job diff for `plan` dry-runs (reference: nomad/structs/diff.go).

Produces a tree of typed diffs — JobDiff → TaskGroupDiff → TaskDiff →
ObjectDiff/FieldDiff — between two versions of a job. The reference flattens
structs via reflection (flatmap + hashstructure); here we flatten dataclasses
generically: primitive fields and string-keyed maps become dotted field
paths, nested dataclasses and lists of dataclasses become child ObjectDiffs
matched by a semantic key (Name / target / label).

`contextual=True` includes unchanged fields inside changed objects so the
renderer can show full context (reference: diff.go:59,177,318 `contextual`).

Copied from nomad_tpu/structs/diff.py; only the imports differ.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Diff types, ordered Edited > Added > Deleted > None for display sorting
# (reference: diff.go:14-45).
DiffTypeNone = "None"
DiffTypeAdded = "Added"
DiffTypeDeleted = "Deleted"
DiffTypeEdited = "Edited"

_TYPE_ORDER = {DiffTypeEdited: 0, DiffTypeAdded: 1, DiffTypeDeleted: 2,
               DiffTypeNone: 3}


@dataclass
class FieldDiff:
    """A single scalar field change (reference: diff.go:846-884)."""

    Type: str = DiffTypeNone
    Name: str = ""
    Old: str = ""
    New: str = ""
    Annotations: List[str] = field(default_factory=list)


@dataclass
class ObjectDiff:
    """A nested object change (reference: diff.go:773-838)."""

    Type: str = DiffTypeNone
    Name: str = ""
    Fields: List[FieldDiff] = field(default_factory=list)
    Objects: List["ObjectDiff"] = field(default_factory=list)


@dataclass
class TaskDiff:
    """(reference: diff.go:308-315)"""

    Type: str = DiffTypeNone
    Name: str = ""
    Fields: List[FieldDiff] = field(default_factory=list)
    Objects: List[ObjectDiff] = field(default_factory=list)
    Annotations: List[str] = field(default_factory=list)


@dataclass
class TaskGroupDiff:
    """(reference: diff.go:165-172)"""

    Type: str = DiffTypeNone
    Name: str = ""
    Fields: List[FieldDiff] = field(default_factory=list)
    Objects: List[ObjectDiff] = field(default_factory=list)
    Tasks: List[TaskDiff] = field(default_factory=list)
    Updates: Dict[str, int] = field(default_factory=dict)


@dataclass
class JobDiff:
    """(reference: diff.go:48-54)"""

    Type: str = DiffTypeNone
    ID: str = ""
    Fields: List[FieldDiff] = field(default_factory=list)
    Objects: List[ObjectDiff] = field(default_factory=list)
    TaskGroups: List[TaskGroupDiff] = field(default_factory=list)


# --------------------------------------------------------------------------
# Flattening: dataclass → {dotted path: rendered string} for primitive leaves.

_PRIMITIVES = (str, int, float, bool)


def _render(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _flatten(obj: Any, prefix: str = "", filter_keys: Tuple[str, ...] = ()
             ) -> Dict[str, str]:
    """Primitive leaves of a dataclass/dict/list as {path: string}.

    Nested dataclasses and lists of dataclasses are skipped — they are
    diffed structurally as child objects, not as flat fields (the
    reference's flatmap.Flatten primitiveOnly behavior).
    """
    out: Dict[str, str] = {}
    if obj is None:
        return out
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.name.startswith("_") or f.name in filter_keys:
                continue
            _flatten_value(f"{prefix}{f.name}", getattr(obj, f.name), out)
        return out
    raise TypeError(f"cannot flatten {type(obj)!r}")


def _flatten_value(key: str, v: Any, out: Dict[str, str]) -> None:
    """Flatten one value: primitives directly, dicts/lists of primitives (or
    nested containers, e.g. driver Config) recursively; nested dataclasses
    are skipped — they diff structurally as child objects."""
    if isinstance(v, _PRIMITIVES):
        out[key] = _render(v)
    elif isinstance(v, dict):
        for k in sorted(v, key=str):
            _flatten_value(f"{key}[{k}]", v[k], out)
    elif isinstance(v, (list, tuple)):
        for i, vv in enumerate(v):
            if dataclasses.is_dataclass(vv):
                break
            _flatten_value(f"{key}[{i}]", vv, out)


def _field_diffs(old_flat: Dict[str, str], new_flat: Dict[str, str],
                 contextual: bool) -> List[FieldDiff]:
    """Diff two flat maps (reference: diff.go:889-933 fieldDiffs)."""
    diffs: List[FieldDiff] = []
    for name in sorted(set(old_flat) | set(new_flat)):
        old_v, new_v = old_flat.get(name), new_flat.get(name)
        if old_v == new_v:
            if contextual:
                diffs.append(FieldDiff(DiffTypeNone, name, old_v or "",
                                       new_v or ""))
            continue
        if old_v is None:
            diffs.append(FieldDiff(DiffTypeAdded, name, "", new_v))
        elif new_v is None:
            diffs.append(FieldDiff(DiffTypeDeleted, name, old_v, ""))
        else:
            diffs.append(FieldDiff(DiffTypeEdited, name, old_v, new_v))
    return diffs


def _object_diff(old: Any, new: Any, name: str, contextual: bool,
                 filter_keys: Tuple[str, ...] = ()) -> Optional[ObjectDiff]:
    """Diff two optional dataclasses into one ObjectDiff, or None if equal
    (reference: diff.go:461-493 serviceDiff et al.)."""
    if old is None and new is None:
        return None
    diff = ObjectDiff(Name=name)
    if old is None:
        diff.Type = DiffTypeAdded
        diff.Fields = _field_diffs({}, _flatten(new, filter_keys=filter_keys),
                                   contextual)
    elif new is None:
        diff.Type = DiffTypeDeleted
        diff.Fields = _field_diffs(_flatten(old, filter_keys=filter_keys), {},
                                   contextual)
    else:
        old_flat = _flatten(old, filter_keys=filter_keys)
        new_flat = _flatten(new, filter_keys=filter_keys)
        if old_flat == new_flat:
            if not contextual:
                return None
            diff.Fields = _field_diffs(old_flat, new_flat, contextual)
        else:
            diff.Type = DiffTypeEdited
            diff.Fields = _field_diffs(old_flat, new_flat, contextual)
    return diff


def _keyed_object_diffs(old_list: List[Any], new_list: List[Any],
                        name: str, key, contextual: bool) -> List[ObjectDiff]:
    """Diff two lists of dataclasses matched by `key(item)`; unmatched items
    become Added/Deleted (reference: diff.go:494-526 serviceDiffs —
    the reference matches set-wise by content hash; we match by semantic
    key so edits render as Edited rather than Deleted+Added). Duplicate
    keys are disambiguated by occurrence index so no item is collapsed."""

    def keyed(items) -> Dict[Tuple[str, int], Any]:
        seen: Dict[str, int] = {}
        out: Dict[Tuple[str, int], Any] = {}
        for item in items:
            k = str(key(item))
            n = seen.get(k, 0)
            seen[k] = n + 1
            out[(k, n)] = item
        return out

    old_by = keyed(old_list)
    new_by = keyed(new_list)
    out: List[ObjectDiff] = []
    for k in sorted(set(old_by) | set(new_by)):
        d = _object_diff(old_by.get(k), new_by.get(k), name, contextual)
        if d is not None and (d.Type != DiffTypeNone or contextual):
            out.append(d)
    return out


def _sort_objects(objs: List[ObjectDiff]) -> List[ObjectDiff]:
    return sorted(objs, key=lambda o: (_TYPE_ORDER.get(o.Type, 9), o.Name))


def _constraint_key(c) -> str:
    return f"{c.LTarget}{c.Operand}{c.RTarget}"


# --------------------------------------------------------------------------
# Per-struct diffs, mirroring the reference's coverage.


def _resources_diff(old, new, contextual: bool) -> Optional[ObjectDiff]:
    """(reference: diff.go:588-659 Resources.Diff + network diffs)"""
    d = _object_diff(old, new, "Resources", contextual)
    old_nets = list(old.Networks) if old is not None else []
    new_nets = list(new.Networks) if new is not None else []
    net_diffs: List[ObjectDiff] = []
    for i in range(max(len(old_nets), len(new_nets))):
        o = old_nets[i] if i < len(old_nets) else None
        n = new_nets[i] if i < len(new_nets) else None
        nd = _object_diff(o, n, "Network", contextual,
                          filter_keys=("Device", "CIDR", "IP"))
        if nd is None:
            # Scalars equal — ports may still differ; diff them below.
            nd = ObjectDiff(Name="Network")
        for label, getter, dyn in (
                ("Static Port", lambda x: x.ReservedPorts, False),
                ("Dynamic Port", lambda x: x.DynamicPorts, True)):
            ports = _keyed_object_diffs(
                getter(o) if o else [], getter(n) if n else [],
                label, lambda p: p.Label, contextual)
            # Dynamic port values are scheduler-assigned; hide them
            # (reference: diff.go:701-752 portDiffs `dynamic`).
            if dyn:
                for pd in ports:
                    pd.Fields = [f for f in pd.Fields if f.Name != "Value"]
            nd.Objects.extend(ports)
        if nd.Type == DiffTypeNone and any(
                od.Type != DiffTypeNone for od in nd.Objects):
            nd.Type = DiffTypeEdited
        if nd.Type != DiffTypeNone or contextual:
            net_diffs.append(nd)
    if net_diffs:
        if d is None:
            d = ObjectDiff(Type=DiffTypeEdited, Name="Resources")
        elif d.Type == DiffTypeNone and any(
                n.Type != DiffTypeNone for n in net_diffs):
            d.Type = DiffTypeEdited
        d.Objects.extend(_sort_objects(net_diffs))
    return d


def _service_diffs(old_list, new_list, contextual: bool) -> List[ObjectDiff]:
    """(reference: diff.go:461-587 service + check diffs)"""
    old_by = {s.Name: s for s in old_list}
    new_by = {s.Name: s for s in new_list}
    out: List[ObjectDiff] = []
    for name in sorted(set(old_by) | set(new_by)):
        o, n = old_by.get(name), new_by.get(name)
        d = _object_diff(o, n, "Service", contextual)
        checks = _keyed_object_diffs(
            list(o.Checks) if o else [], list(n.Checks) if n else [],
            "Check", lambda c: c.Name, contextual)
        if checks:
            changed = any(c.Type != DiffTypeNone for c in checks)
            if d is None:
                d = ObjectDiff(
                    Type=DiffTypeEdited if changed else DiffTypeNone,
                    Name="Service")
            elif d.Type == DiffTypeNone and changed:
                d.Type = DiffTypeEdited
            d.Objects.extend(checks)
        if d is not None and (d.Type != DiffTypeNone or contextual):
            out.append(d)
    return out


def task_diff(old, new, contextual: bool = False) -> TaskDiff:
    """Diff two Tasks (reference: diff.go:318-395 Task.Diff)."""
    diff = TaskDiff()
    if old is None and new is None:
        return diff
    if old is None:
        diff.Type, diff.Name = DiffTypeAdded, new.Name
        diff.Fields = _field_diffs({}, _flatten(new), contextual)
    elif new is None:
        diff.Type, diff.Name = DiffTypeDeleted, old.Name
        diff.Fields = _field_diffs(_flatten(old), {}, contextual)
    else:
        diff.Name = new.Name
        old_flat, new_flat = _flatten(old), _flatten(new)
        diff.Fields = _field_diffs(old_flat, new_flat, contextual)
        if any(f.Type != DiffTypeNone for f in diff.Fields):
            diff.Type = DiffTypeEdited

    objs: List[ObjectDiff] = []
    objs.extend(_keyed_object_diffs(
        list(old.Constraints) if old else [],
        list(new.Constraints) if new else [],
        "Constraint", _constraint_key, contextual))
    r = _resources_diff(old.Resources if old else None,
                        new.Resources if new else None, contextual)
    if r is not None and (r.Type != DiffTypeNone or contextual):
        objs.append(r)
    lc = _object_diff(old.LogConfig if old else None,
                      new.LogConfig if new else None, "LogConfig", contextual)
    if lc is not None and (lc.Type != DiffTypeNone or contextual):
        objs.append(lc)
    objs.extend(_service_diffs(list(old.Services) if old else [],
                               list(new.Services) if new else [], contextual))
    objs.extend(_keyed_object_diffs(
        list(old.Artifacts) if old else [],
        list(new.Artifacts) if new else [],
        "Artifact", lambda a: a.GetterSource, contextual))
    diff.Objects = _sort_objects(objs)
    if diff.Type == DiffTypeNone and any(
            o.Type != DiffTypeNone for o in diff.Objects):
        diff.Type = DiffTypeEdited
    return diff


def task_group_diff(old, new, contextual: bool = False) -> TaskGroupDiff:
    """Diff two TaskGroups (reference: diff.go:177-235 TaskGroup.Diff)."""
    diff = TaskGroupDiff()
    if old is None and new is None:
        return diff
    if old is None:
        diff.Type, diff.Name = DiffTypeAdded, new.Name
        diff.Fields = _field_diffs({}, _flatten(new), contextual)
    elif new is None:
        diff.Type, diff.Name = DiffTypeDeleted, old.Name
        diff.Fields = _field_diffs(_flatten(old), {}, contextual)
    else:
        diff.Name = new.Name
        diff.Fields = _field_diffs(_flatten(old), _flatten(new), contextual)
        if any(f.Type != DiffTypeNone for f in diff.Fields):
            diff.Type = DiffTypeEdited

    objs: List[ObjectDiff] = []
    objs.extend(_keyed_object_diffs(
        list(old.Constraints) if old else [],
        list(new.Constraints) if new else [],
        "Constraint", _constraint_key, contextual))
    rp = _object_diff(old.RestartPolicy if old else None,
                      new.RestartPolicy if new else None,
                      "RestartPolicy", contextual)
    if rp is not None and (rp.Type != DiffTypeNone or contextual):
        objs.append(rp)
    diff.Objects = _sort_objects(objs)

    old_tasks = {t.Name: t for t in (old.Tasks if old else [])}
    new_tasks = {t.Name: t for t in (new.Tasks if new else [])}
    tasks: List[TaskDiff] = []
    for name in sorted(set(old_tasks) | set(new_tasks)):
        td = task_diff(old_tasks.get(name), new_tasks.get(name), contextual)
        if td.Type != DiffTypeNone or contextual:
            tasks.append(td)
    diff.Tasks = sorted(tasks, key=lambda t: (_TYPE_ORDER.get(t.Type, 9),
                                              t.Name))
    if diff.Type == DiffTypeNone and (
            any(o.Type != DiffTypeNone for o in diff.Objects)
            or any(t.Type != DiffTypeNone for t in diff.Tasks)):
        diff.Type = DiffTypeEdited
    return diff


# Fields excluded from the job-level flat diff — server-maintained bookkeeping
# (reference: diff.go:61 `filter`).
_JOB_FILTER = ("ID", "Status", "StatusDescription", "CreateIndex",
               "ModifyIndex", "JobModifyIndex")


def job_diff(old, new, contextual: bool = False) -> JobDiff:
    """Diff two Jobs (reference: diff.go:59-145 Job.Diff).

    Either side may be None (pure registration / pure deregistration).
    """
    diff = JobDiff()
    if old is None and new is None:
        return diff
    if old is not None and new is not None and old.ID != new.ID:
        raise ValueError(f"cannot diff jobs with different IDs: "
                         f"{old.ID!r} vs {new.ID!r}")
    if old is None:
        diff.Type, diff.ID = DiffTypeAdded, new.ID
        diff.Fields = _field_diffs({}, _flatten(new, filter_keys=_JOB_FILTER),
                                   contextual)
    elif new is None:
        diff.Type, diff.ID = DiffTypeDeleted, old.ID
        diff.Fields = _field_diffs(_flatten(old, filter_keys=_JOB_FILTER), {},
                                   contextual)
    else:
        diff.ID = new.ID
        diff.Fields = _field_diffs(_flatten(old, filter_keys=_JOB_FILTER),
                                   _flatten(new, filter_keys=_JOB_FILTER),
                                   contextual)
        if any(f.Type != DiffTypeNone for f in diff.Fields):
            diff.Type = DiffTypeEdited

    objs: List[ObjectDiff] = []
    objs.extend(_keyed_object_diffs(
        list(old.Constraints) if old else [],
        list(new.Constraints) if new else [],
        "Constraint", _constraint_key, contextual))
    up = _object_diff(old.Update if old else None,
                      new.Update if new else None, "Update", contextual)
    if up is not None and (up.Type != DiffTypeNone or contextual):
        objs.append(up)
    per = _object_diff(old.Periodic if old else None,
                       new.Periodic if new else None, "Periodic", contextual)
    if per is not None and (per.Type != DiffTypeNone or contextual):
        objs.append(per)
    diff.Objects = _sort_objects(objs)

    old_tgs = {tg.Name: tg for tg in (old.TaskGroups if old else [])}
    new_tgs = {tg.Name: tg for tg in (new.TaskGroups if new else [])}
    tgs: List[TaskGroupDiff] = []
    for name in sorted(set(old_tgs) | set(new_tgs)):
        tgd = task_group_diff(old_tgs.get(name), new_tgs.get(name),
                              contextual)
        if tgd.Type != DiffTypeNone or contextual:
            tgs.append(tgd)
    diff.TaskGroups = sorted(tgs, key=lambda t: t.Name)
    if diff.Type == DiffTypeNone and (
            any(o.Type != DiffTypeNone for o in diff.Objects)
            or any(t.Type != DiffTypeNone for t in diff.TaskGroups)):
        diff.Type = DiffTypeEdited
    return diff
