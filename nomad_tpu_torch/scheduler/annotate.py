"""Annotate a job diff with scheduler-desired actions for `plan` output
(reference: scheduler/annotate.go:37-185).

Takes the structural JobDiff between the submitted and existing job plus the
dry-run scheduler's PlanAnnotations (per-task-group DesiredUpdates) and
decorates the diff so a human can see what the plan would actually do:
count changes force creates/destroys, task edits force in-place or
destructive updates.

Copied from nomad_tpu/scheduler/annotate.py; only the imports differ.
"""

from __future__ import annotations

from typing import Optional

from nomad_tpu_torch.structs.diff import (
    DiffTypeAdded,
    DiffTypeDeleted,
    DiffTypeEdited,
    DiffTypeNone,
    JobDiff,
    TaskDiff,
    TaskGroupDiff,
)

AnnotationForcesCreate = "forces create"
AnnotationForcesDestroy = "forces destroy"
AnnotationForcesInplaceUpdate = "forces in-place update"
AnnotationForcesDestructiveUpdate = "forces create/destroy update"

UpdateTypeIgnore = "ignore"
UpdateTypeCreate = "create"
UpdateTypeDestroy = "destroy"
UpdateTypeMigrate = "migrate"
UpdateTypeInplaceUpdate = "in-place update"
UpdateTypeDestructiveUpdate = "create/destroy update"


def annotate(diff: JobDiff, annotations) -> None:
    """(reference: annotate.go:37-51 Annotate)"""
    for tg_diff in diff.TaskGroups:
        _annotate_task_group(tg_diff, annotations)


def _annotate_task_group(diff: TaskGroupDiff, annotations) -> None:
    """(reference: annotate.go:53-100 annotateTaskGroup)"""
    if annotations is not None:
        tg = annotations.DesiredTGUpdates.get(diff.Name)
        if tg is not None:
            for key, count in ((UpdateTypeIgnore, tg.Ignore),
                               (UpdateTypeCreate, tg.Place),
                               (UpdateTypeMigrate, tg.Migrate),
                               (UpdateTypeDestroy, tg.Stop),
                               (UpdateTypeInplaceUpdate, tg.InPlaceUpdate),
                               (UpdateTypeDestructiveUpdate,
                                tg.DestructiveUpdate)):
                if count:
                    diff.Updates[key] = count

    _annotate_count_change(diff)
    for task_d in diff.Tasks:
        _annotate_task(task_d, diff)


def _annotate_count_change(diff: TaskGroupDiff) -> None:
    """(reference: annotate.go:103-143 annotateCountChange)"""
    count_diff = next((f for f in diff.Fields if f.Name == "Count"), None)
    if count_diff is None:
        return
    old_v = int(count_diff.Old) if count_diff.Old else 0
    new_v = int(count_diff.New) if count_diff.New else 0
    if old_v < new_v:
        count_diff.Annotations.append(AnnotationForcesCreate)
    elif new_v < old_v:
        count_diff.Annotations.append(AnnotationForcesDestroy)


def _annotate_task(diff: TaskDiff, parent: TaskGroupDiff) -> None:
    """(reference: annotate.go:146-185 annotateTask)"""
    if diff.Type == DiffTypeNone:
        return

    # Inside a wholly added/deleted group the task fate follows the group.
    if parent.Type in (DiffTypeAdded, DiffTypeDeleted):
        if diff.Type == DiffTypeAdded:
            diff.Annotations.append(AnnotationForcesCreate)
            return
        if diff.Type == DiffTypeDeleted:
            diff.Annotations.append(AnnotationForcesDestroy)
            return

    if diff.Type in (DiffTypeAdded, DiffTypeDeleted):
        diff.Annotations.append(AnnotationForcesDestructiveUpdate)
        return

    # Edited: every primitive-field change is destructive; only LogConfig,
    # Service, and Constraint object edits go in place (reference:
    # annotate.go:161-183 — note the reference is deliberately more
    # conservative here than tasksUpdated, util.go:291).
    destructive = any(f.Type != DiffTypeNone for f in diff.Fields)
    if not destructive:
        for o in diff.Objects:
            if (o.Type != DiffTypeNone
                    and o.Name not in ("LogConfig", "Service", "Constraint")):
                destructive = True
                break
    diff.Annotations.append(
        AnnotationForcesDestructiveUpdate if destructive
        else AnnotationForcesInplaceUpdate)
