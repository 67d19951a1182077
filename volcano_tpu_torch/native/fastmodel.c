/* fastmodel: the native engine of volcano_tpu_torch's snapshot clones and
 * bind commit path.
 *
 * Every entry here computes exactly what a Python body of the package
 * computes, field for field, and is called from that body's place when
 * the body's switch is on (apiserver/store.py NATIVE_PUBLISH,
 * cache/cache.py NATIVE_APPLY, cache/event_handlers.py NATIVE_ECHO,
 * trace/ledger.py NATIVE_CONFIRM, models/job_info.py NATIVE_CLONE). The
 * Python bodies stay beside them as the plain version; the tests hold the
 * two against each other.
 *
 * The snapshot clones TaskInfo (50,000 at the north star's size) by a
 * fixed set of pointer copies and increfs: the slot offsets are read from
 * the class's member descriptors when it is registered, so the layout
 * always follows the Python definition.
 *
 * Some entries hand items back to Python by design, and say so where they
 * do: bind_apply_bursts returns False with nothing changed on a shape its
 * one pass does not cover, bind_echo_apply stops at the first pair its
 * guards decline, bind_clone_pods returns None for a shard with a pod
 * whose request was never parsed. Every other failure raises.
 *
 * Every entry runs with the interpreter lock held and the caller's lock
 * (the store's, the cache's mutex, the ledger's) taken, as the Python
 * body does.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>
#include <math.h>

#define MAX_SLOTS 64

static PyTypeObject *task_type = NULL;
static Py_ssize_t task_offsets[MAX_SLOTS];
static int n_task_slots = -1;
static Py_ssize_t status_offset = -1;
static Py_ssize_t uid_offset = -1;
/* extra named TaskInfo slots for the bind-echo/apply passes */
static Py_ssize_t t_node_name_off = -1, t_job_off = -1, t_pod_off = -1,
                  t_resreq_off = -1, t_key_off = -1;

/* offset of one named slot's member descriptor on tp (resolved through
 * tp so shadowed names land on the instance's real storage); -1 with an
 * exception set on failure */
static Py_ssize_t
member_offset(PyTypeObject *tp, const char *name)
{
    PyObject *descr = PyObject_GetAttrString((PyObject *)tp, name);
    if (descr == NULL)
        return -1;
    if (Py_TYPE(descr) != &PyMemberDescr_Type) {
        Py_DECREF(descr);
        PyErr_Format(PyExc_TypeError, "%s.%s is not a slot descriptor",
                     tp->tp_name, name);
        return -1;
    }
    Py_ssize_t off = ((PyMemberDescrObject *)descr)->d_member->offset;
    Py_DECREF(descr);
    return off;
}

/* Collect the member-descriptor offsets of every slot an instance of tp
 * carries — walking the whole MRO, not just tp's own __slots__, so a
 * subclass of a slotted model registers ALL storage (its own slots plus
 * the inherited ones). A clone that copied only the leaf class's slots
 * would silently leave the base's fields NULL. Any MRO entry (other
 * than object) WITHOUT __slots__ rejects the registration: it gives
 * instances a __dict__ this copier would not clone. Optionally reports
 * the offsets of up to two named slots (want_a/want_b, NULL to skip).
 * Writes ONLY into caller-provided storage so a failed registration can
 * commit atomically. */
static int
collect_one_class(PyTypeObject *tp, PyObject *klass, Py_ssize_t *offsets,
                  int *count, const char *want_a, Py_ssize_t *off_a,
                  const char *want_b, Py_ssize_t *off_b)
{
    PyObject *slots = PyObject_GetAttrString(klass, "__slots__");
    if (slots == NULL) {
        PyErr_Format(PyExc_TypeError,
                     "%s in the MRO of %s has no __slots__ (instances "
                     "would carry a __dict__ the slot copier cannot "
                     "clone)",
                     ((PyTypeObject *)klass)->tp_name, tp->tp_name);
        return -1;
    }
    /* a bare-string __slots__ declares ONE slot, not len(str) of them */
    if (PyUnicode_Check(slots)) {
        PyObject *tup = PyTuple_Pack(1, slots);
        Py_DECREF(slots);
        if (tup == NULL)
            return -1;
        slots = tup;
    }
    PyObject *seq = PySequence_Fast(slots, "__slots__ not a sequence");
    Py_DECREF(slots);
    if (seq == NULL)
        return -1;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *name = PySequence_Fast_GET_ITEM(seq, i);
        /* resolve through tp, not klass: a shadowed name must land on
         * the storage the instance actually uses */
        PyObject *descr = PyObject_GetAttr((PyObject *)tp, name);
        if (descr == NULL) {
            Py_DECREF(seq);
            return -1;
        }
        if (Py_TYPE(descr) != &PyMemberDescr_Type) {
            Py_DECREF(descr);
            Py_DECREF(seq);
            PyErr_SetString(PyExc_TypeError,
                            "slot attr is not a member descriptor");
            return -1;
        }
        PyMemberDef *m = ((PyMemberDescrObject *)descr)->d_member;
        Py_DECREF(descr);
        int dup = 0;
        for (int j = 0; j < *count; j++)
            if (offsets[j] == m->offset) { dup = 1; break; }
        if (!dup) {
            if (*count >= MAX_SLOTS) {
                Py_DECREF(seq);
                PyErr_SetString(PyExc_ValueError, "too many slots");
                return -1;
            }
            offsets[(*count)++] = m->offset;
        }
        const char *cname = PyUnicode_AsUTF8(name);
        if (cname != NULL) {
            if (want_a != NULL && strcmp(cname, want_a) == 0)
                *off_a = m->offset;
            if (want_b != NULL && strcmp(cname, want_b) == 0)
                *off_b = m->offset;
        }
    }
    Py_DECREF(seq);
    return 0;
}

static int
collect_offsets(PyTypeObject *tp, Py_ssize_t *offsets, int *count,
                const char *want_a, Py_ssize_t *off_a,
                const char *want_b, Py_ssize_t *off_b)
{
    /* the authoritative __dict__ check: ANY slotless class in the
     * hierarchy (including a subclass that merely inherits __slots__
     * without declaring its own) gives instances a dict, and dict state
     * is invisible to the slot copier. tp_dictoffset is how the
     * interpreter itself records that. */
    if (tp->tp_dictoffset != 0) {
        PyErr_Format(PyExc_TypeError,
                     "%s instances carry a __dict__ (some class in the "
                     "hierarchy lacks __slots__); the slot copier would "
                     "clone it partially", tp->tp_name);
        return -1;
    }
    PyObject *mro = tp->tp_mro;
    if (mro == NULL || !PyTuple_Check(mro)) {
        PyErr_SetString(PyExc_TypeError, "type has no MRO");
        return -1;
    }
    *count = 0;
    for (Py_ssize_t k = 0; k < PyTuple_GET_SIZE(mro); k++) {
        PyObject *klass = PyTuple_GET_ITEM(mro, k);
        if (klass == (PyObject *)&PyBaseObject_Type)
            continue;
        if (collect_one_class(tp, klass, offsets, count,
                              want_a, off_a, want_b, off_b) < 0)
            return -1;
    }
    return 0;
}

static PyObject *
register_task_type(PyObject *self, PyObject *arg)
{
    if (!PyType_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected a type");
        return NULL;
    }
    PyTypeObject *tp = (PyTypeObject *)arg;
    /* stage into locals; commit globals only on full success */
    Py_ssize_t offsets[MAX_SLOTS];
    int count = 0;
    Py_ssize_t st_off = -1, u_off = -1;
    if (collect_offsets(tp, offsets, &count, "status", &st_off,
                        "uid", &u_off) < 0)
        return NULL;
    if (st_off < 0 || u_off < 0) {
        PyErr_SetString(PyExc_ValueError, "type lacks status/uid slots");
        return NULL;
    }
    Py_ssize_t nn_off = member_offset(tp, "node_name");
    Py_ssize_t j_off = member_offset(tp, "job");
    Py_ssize_t p_off = member_offset(tp, "pod");
    Py_ssize_t rr_off = member_offset(tp, "resreq");
    Py_ssize_t k_off = member_offset(tp, "key_cache");
    if (nn_off < 0 || j_off < 0 || p_off < 0 || rr_off < 0 || k_off < 0)
        return NULL;
    memcpy(task_offsets, offsets, sizeof(offsets[0]) * count);
    n_task_slots = count;
    status_offset = st_off;
    uid_offset = u_off;
    t_node_name_off = nn_off;
    t_job_off = j_off;
    t_pod_off = p_off;
    t_resreq_off = rr_off;
    t_key_off = k_off;
    Py_XDECREF((PyObject *)task_type);
    Py_INCREF(arg);
    task_type = tp;
    Py_RETURN_NONE;
}

/* ---- TaskStatus members + allocated set (bind-echo pass) ---- */

static PyObject *ts_running = NULL, *ts_releasing = NULL, *ts_bound = NULL,
                *ts_pending = NULL, *ts_succeeded = NULL, *ts_failed = NULL,
                *ts_unknown = NULL, *ts_allocated_set = NULL;

/* register_task_status(TaskStatus, allocated_statuses): capture the enum
 * members the C twin of job_info.get_task_status hands back, plus the
 * allocated-status set. */
static PyObject *
register_task_status(PyObject *self, PyObject *args)
{
    PyObject *cls, *allocated;
    if (!PyArg_ParseTuple(args, "OO", &cls, &allocated))
        return NULL;
    PyObject *run = PyObject_GetAttrString(cls, "Running");
    PyObject *rel = PyObject_GetAttrString(cls, "Releasing");
    PyObject *bnd = PyObject_GetAttrString(cls, "Bound");
    PyObject *pen = PyObject_GetAttrString(cls, "Pending");
    PyObject *suc = PyObject_GetAttrString(cls, "Succeeded");
    PyObject *fai = PyObject_GetAttrString(cls, "Failed");
    PyObject *unk = PyObject_GetAttrString(cls, "Unknown");
    if (run == NULL || rel == NULL || bnd == NULL || pen == NULL ||
        suc == NULL || fai == NULL || unk == NULL) {
        Py_XDECREF(run); Py_XDECREF(rel); Py_XDECREF(bnd); Py_XDECREF(pen);
        Py_XDECREF(suc); Py_XDECREF(fai); Py_XDECREF(unk);
        return NULL;
    }
    PyObject *alloc_set = PySet_New(allocated);
    if (alloc_set == NULL) {
        Py_DECREF(run); Py_DECREF(rel); Py_DECREF(bnd); Py_DECREF(pen);
        Py_DECREF(suc); Py_DECREF(fai); Py_DECREF(unk);
        return NULL;
    }
    Py_XDECREF(ts_running);   ts_running = run;
    Py_XDECREF(ts_releasing); ts_releasing = rel;
    Py_XDECREF(ts_bound);     ts_bound = bnd;
    Py_XDECREF(ts_pending);   ts_pending = pen;
    Py_XDECREF(ts_succeeded); ts_succeeded = suc;
    Py_XDECREF(ts_failed);    ts_failed = fai;
    Py_XDECREF(ts_unknown);   ts_unknown = unk;
    Py_XDECREF(ts_allocated_set); ts_allocated_set = alloc_set;
    Py_RETURN_NONE;
}

/* TaskInfo.clone: a new instance of the registered class (as
 * TaskInfo.__new__(TaskInfo) makes it, for a subclass's task too) with
 * the registered slots copied; src is an instance of the class */
static inline PyObject *
clone_one(PyObject *src)
{
    PyObject *dst = task_type->tp_alloc(task_type, 0);
    if (dst == NULL)
        return NULL;
    char *s = (char *)src, *d = (char *)dst;
    for (int i = 0; i < n_task_slots; i++) {
        PyObject *v = *(PyObject **)(s + task_offsets[i]);
        Py_XINCREF(v);
        *(PyObject **)(d + task_offsets[i]) = v;
    }
    return dst;
}

static PyObject *
clone_task(PyObject *self, PyObject *arg)
{
    if (n_task_slots < 0 || !PyObject_TypeCheck(arg, task_type)) {
        PyErr_SetString(PyExc_TypeError, "not a registered TaskInfo");
        return NULL;
    }
    return clone_one(arg);
}

/* clone_task_table(tasks: dict[uid, TaskInfo])
 *    -> (new_tasks: dict, index: dict[status, dict[uid, TaskInfo]])
 * Every value must be an instance of the registered class. */
static PyObject *
clone_task_table(PyObject *self, PyObject *arg)
{
    if (n_task_slots < 0) {
        PyErr_SetString(PyExc_RuntimeError, "task type not registered");
        return NULL;
    }
    if (!PyDict_CheckExact(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected a dict");
        return NULL;
    }
    PyObject *new_tasks = PyDict_New();
    PyObject *index = PyDict_New();
    if (new_tasks == NULL || index == NULL)
        goto fail;
    Py_ssize_t pos = 0;
    PyObject *key, *value;
    while (PyDict_Next(arg, &pos, &key, &value)) {
        if (!PyObject_TypeCheck(value, task_type)) {
            PyErr_SetString(PyExc_TypeError, "not a TaskInfo");
            goto fail;
        }
        PyObject *c = clone_one(value);
        if (c == NULL)
            goto fail;
        if (PyDict_SetItem(new_tasks, key, c) < 0) {
            Py_DECREF(c);
            goto fail;
        }
        PyObject *status = *(PyObject **)((char *)c + status_offset);
        PyObject *bucket = PyDict_GetItemWithError(index, status);
        if (bucket == NULL) {
            if (PyErr_Occurred()) {
                Py_DECREF(c);
                goto fail;
            }
            bucket = PyDict_New();
            if (bucket == NULL || PyDict_SetItem(index, status, bucket) < 0) {
                Py_XDECREF(bucket);
                Py_DECREF(c);
                goto fail;
            }
            Py_DECREF(bucket);  /* index holds it */
        }
        if (PyDict_SetItem(bucket, key, c) < 0) {
            Py_DECREF(c);
            goto fail;
        }
        Py_DECREF(c);
    }
    return Py_BuildValue("(NN)", new_tasks, index);
fail:
    Py_XDECREF(new_tasks);
    Py_XDECREF(index);
    return NULL;
}

/* clone_task_dict(tasks) -> dict of cloned tasks (no status index) —
 * NodeInfo.tasks clones. */
static PyObject *
clone_task_dict(PyObject *self, PyObject *arg)
{
    if (n_task_slots < 0 || !PyDict_CheckExact(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected a dict (registered type)");
        return NULL;
    }
    PyObject *out = PyDict_New();
    if (out == NULL)
        return NULL;
    Py_ssize_t pos = 0;
    PyObject *key, *value;
    while (PyDict_Next(arg, &pos, &key, &value)) {
        if (!PyObject_TypeCheck(value, task_type)) {
            Py_DECREF(out);
            PyErr_SetString(PyExc_TypeError, "not a TaskInfo");
            return NULL;
        }
        PyObject *c = clone_one(value);
        if (c == NULL || PyDict_SetItem(out, key, c) < 0) {
            Py_XDECREF(c);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(c);
    }
    return out;
}

/* ---- Resource (slots: milli_cpu, memory, scalars, max_task_num) ---- */

static PyTypeObject *res_type = NULL;
static Py_ssize_t res_offsets[MAX_SLOTS];
static int n_res_slots = -1;
static Py_ssize_t res_scalars_offset = -1;
static Py_ssize_t res_cpu_offset = -1, res_mem_offset = -1;

static PyObject *
register_resource_type(PyObject *self, PyObject *arg)
{
    if (!PyType_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected a type");
        return NULL;
    }
    PyTypeObject *tp = (PyTypeObject *)arg;
    /* stage into locals; commit globals only on full success */
    Py_ssize_t offsets[MAX_SLOTS];
    int count = 0;
    Py_ssize_t sc_off = -1;
    if (collect_offsets(tp, offsets, &count, "scalars", &sc_off,
                        NULL, NULL) < 0)
        return NULL;
    if (sc_off < 0) {
        PyErr_SetString(PyExc_ValueError, "type lacks a scalars slot");
        return NULL;
    }
    Py_ssize_t cpu_off = member_offset(tp, "milli_cpu");
    Py_ssize_t mem_off = member_offset(tp, "memory");
    if (cpu_off < 0 || mem_off < 0)
        return NULL;
    memcpy(res_offsets, offsets, sizeof(offsets[0]) * count);
    n_res_slots = count;
    res_scalars_offset = sc_off;
    res_cpu_offset = cpu_off;
    res_mem_offset = mem_off;
    Py_XDECREF((PyObject *)res_type);
    Py_INCREF(arg);
    res_type = tp;
    Py_RETURN_NONE;
}

static PyObject *
clone_resource(PyObject *self, PyObject *arg)
{
    if (n_res_slots < 0 || !PyObject_TypeCheck(arg, res_type)) {
        PyErr_SetString(PyExc_TypeError, "not a registered Resource");
        return NULL;
    }
    PyObject *dst = res_type->tp_alloc(res_type, 0);
    if (dst == NULL)
        return NULL;
    char *s = (char *)arg, *d = (char *)dst;
    for (int i = 0; i < n_res_slots; i++) {
        PyObject *v = *(PyObject **)(s + res_offsets[i]);
        if (res_offsets[i] == res_scalars_offset && v != NULL) {
            PyObject *copy = PyDict_Copy(v);
            if (copy == NULL) {
                Py_DECREF(dst);
                return NULL;
            }
            *(PyObject **)(d + res_offsets[i]) = copy;
        } else {
            Py_XINCREF(v);
            *(PyObject **)(d + res_offsets[i]) = v;
        }
    }
    return dst;
}

/* interned attribute names and values (module init) */
static PyObject *s_modified, *s_uid, *s_deletion_timestamp, *s_phase,
    *s_status, *ph_running, *ph_pending, *ph_succeeded, *ph_failed;
/* ---- __dict__ helpers for plain classes ---- */

/* interned attribute keys for the bind-clone hot loop (module init) */
static PyObject *s_metadata, *s_spec, *s_node_name, *s_resource_version;

/* new instance of tp adopting nd as its __dict__ (steals no refs;
 * the instance takes its own). NULL on failure. */
static PyObject *
adopt_dict(PyTypeObject *tp, PyObject *nd)
{
    PyObject *dst = tp->tp_alloc(tp, 0);
    if (dst == NULL)
        return NULL;
    PyObject **dp = _PyObject_GetDictPtr(dst);
    if (dp == NULL) {
        Py_DECREF(dst);
        PyErr_Format(PyExc_TypeError, "%s instances carry no __dict__",
                     tp->tp_name);
        return NULL;
    }
    Py_INCREF(nd);
    *dp = nd;
    return dst;
}
/* borrowed __dict__ value of a plain-object attribute, or NULL (no
 * exception): obj.__dict__[name] without the descriptor machinery */
static inline PyObject *
dict_attr(PyObject *o, PyObject *name)
{
    PyObject **dp = _PyObject_GetDictPtr(o);
    if (dp == NULL || *dp == NULL)
        return NULL;
    return PyDict_GetItemWithError(*dp, name);   /* borrowed */
}

static inline int
str_eq(PyObject *a, PyObject *b)
{
    if (a == b)
        return 1;
    if (a == NULL || b == NULL)
        return 0;
    if (PyUnicode_Check(a) && PyUnicode_Check(b))
        return PyUnicode_Compare(a, b) == 0 && !PyErr_Occurred();
    return PyObject_RichCompareBool(a, b, Py_EQ) == 1;
}

/* C twin of job_info.get_task_status: pod phase (+ node_name and
 * deletion_timestamp) -> registered TaskStatus member (borrowed ref,
 * NULL when the pod's shape is unexpected: the caller hands the pair
 * back) */
static PyObject *
task_status_of(PyObject *pod_dict, PyObject *meta, PyObject *spec)
{
    PyObject *status = PyDict_GetItemWithError(pod_dict, s_status);
    if (status == NULL)
        return NULL;
    PyObject *phase = dict_attr(status, s_phase);
    if (phase == NULL)
        return NULL;
    if (str_eq(phase, ph_running)) {
        PyObject *dt = dict_attr(meta, s_deletion_timestamp);
        return (dt != NULL && dt != Py_None) ? ts_releasing : ts_running;
    }
    if (str_eq(phase, ph_pending)) {
        PyObject *dt = dict_attr(meta, s_deletion_timestamp);
        if (dt != NULL && dt != Py_None)
            return ts_releasing;
        PyObject *nn = dict_attr(spec, s_node_name);
        int truthy = nn == NULL ? 0 : PyObject_IsTrue(nn);
        if (truthy < 0)
            return NULL;
        return truthy ? ts_bound : ts_pending;
    }
    if (str_eq(phase, ph_succeeded))
        return ts_succeeded;
    if (str_eq(phase, ph_failed))
        return ts_failed;
    return ts_unknown;
}

/* slot write with refcount handling */
static inline void
slot_store(PyObject *o, Py_ssize_t off, PyObject *v)
{
    PyObject **p = (PyObject **)((char *)o + off);
    PyObject *old = *p;
    Py_XINCREF(v);
    *p = v;
    Py_XDECREF(old);
}

#define TASK_SLOT(t, off) (*(PyObject **)((char *)(t) + (off)))

/* ---- the store's bind clone (models/objects.py clone_pod_for_bind) ---- */

static PyTypeObject *pod_type = NULL, *meta_type = NULL, *spec_type = NULL;
static PyObject *s_rr, *s_group_sig;

/* register_pod_types(Pod, ObjectMeta, PodSpec): the classes the bind
 * clone builds, as clone_pod_for_bind's object.__new__ calls name them */
static PyObject *
register_pod_types(PyObject *self, PyObject *args)
{
    PyObject *p, *m, *s;
    if (!PyArg_ParseTuple(args, "O!O!O!", &PyType_Type, &p, &PyType_Type,
                          &m, &PyType_Type, &s))
        return NULL;
    PyTypeObject *types[3] = {(PyTypeObject *)p, (PyTypeObject *)m,
                              (PyTypeObject *)s};
    for (int i = 0; i < 3; i++)
        if (types[i]->tp_dictoffset == 0) {
            PyErr_Format(PyExc_TypeError, "%s instances carry no __dict__",
                         types[i]->tp_name);
            return NULL;
        }
    Py_INCREF(p);
    Py_XSETREF(pod_type, (PyTypeObject *)p);
    Py_INCREF(m);
    Py_XSETREF(meta_type, (PyTypeObject *)m);
    Py_INCREF(s);
    Py_XSETREF(spec_type, (PyTypeObject *)s);
    Py_RETURN_NONE;
}

/* the __dict__ of o, borrowed, or NULL (no exception) when it has none */
static inline PyObject *
dict_of(PyObject *o)
{
    PyObject **dp = _PyObject_GetDictPtr(o);
    return dp == NULL ? NULL : *dp;
}

/* bind_clone_pods(pods, hostnames, rv_start) -> list[Pod] | None
 *
 * The clone, patch and rv step of one shard of ObjectStore.bind_pods in
 * one call: for each stored pod, clone_pod_for_bind's shells (a fresh
 * pod, metadata and spec; status, labels, annotations and every spec
 * subtree shared with the stored object; the parse cache _rr and the
 * group-signature intern carried over), spec.node_name set to
 * hostnames[i] and metadata.resource_version to rv_start + i.
 *
 * Returns None, having built nothing, when a pod lacks the shape (a
 * metadata, spec or status, or the parsed request _rr, which the Python
 * patch would compute): a designed hand-back, the caller runs the shard's
 * Python loop, which handles it. */
static PyObject *
bind_clone_pods(PyObject *self, PyObject *args)
{
    PyObject *pods, *hosts;
    long long rv_start;
    if (!PyArg_ParseTuple(args, "O!O!L", &PyList_Type, &pods,
                          &PyList_Type, &hosts, &rv_start))
        return NULL;
    if (pod_type == NULL) {
        PyErr_SetString(PyExc_RuntimeError, "pod types not registered");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(pods);
    if (PyList_GET_SIZE(hosts) != n) {
        PyErr_SetString(PyExc_ValueError, "pods/hostnames length mismatch");
        return NULL;
    }
    /* the shape check first, so a hand-back builds nothing */
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *sd = dict_of(PyList_GET_ITEM(pods, i));
        PyObject *meta = sd == NULL ? NULL
            : PyDict_GetItemWithError(sd, s_metadata);
        PyObject *spec = sd == NULL ? NULL
            : PyDict_GetItemWithError(sd, s_spec);
        PyObject *status = sd == NULL ? NULL
            : PyDict_GetItemWithError(sd, s_status);
        PyObject *rr = sd == NULL ? NULL : PyDict_GetItemWithError(sd, s_rr);
        if (PyErr_Occurred())
            return NULL;
        if (meta == NULL || spec == NULL || status == NULL || rr == NULL
                || rr == Py_None || dict_of(meta) == NULL
                || dict_of(spec) == NULL)
            Py_RETURN_NONE;
    }
    PyObject *out = PyList_New(n);
    if (out == NULL)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *sd = dict_of(PyList_GET_ITEM(pods, i));
        PyObject *md = PyDict_Copy(dict_of(PyDict_GetItem(sd, s_metadata)));
        PyObject *spd = PyDict_Copy(dict_of(PyDict_GetItem(sd, s_spec)));
        PyObject *rv = PyLong_FromLongLong(rv_start + (long long)i);
        PyObject *nd = PyDict_New();
        PyObject *nmeta = NULL, *nspec = NULL, *dst = NULL;
        int ok = md != NULL && spd != NULL && rv != NULL && nd != NULL
            && PyDict_SetItem(md, s_resource_version, rv) == 0
            && PyDict_SetItem(spd, s_node_name,
                              PyList_GET_ITEM(hosts, i)) == 0
            && (nmeta = adopt_dict(meta_type, md)) != NULL
            && (nspec = adopt_dict(spec_type, spd)) != NULL
            && PyDict_SetItem(nd, s_metadata, nmeta) == 0
            && PyDict_SetItem(nd, s_spec, nspec) == 0
            && PyDict_SetItem(nd, s_status,
                              PyDict_GetItem(sd, s_status)) == 0
            && PyDict_SetItem(nd, s_rr, PyDict_GetItem(sd, s_rr)) == 0;
        if (ok) {
            PyObject *sig = PyDict_GetItemWithError(sd, s_group_sig);
            ok = !PyErr_Occurred() && (sig == NULL || sig == Py_None
                || PyDict_SetItem(nd, s_group_sig, sig) == 0);
        }
        if (ok)
            ok = (dst = adopt_dict(pod_type, nd)) != NULL;
        Py_XDECREF(md);
        Py_XDECREF(spd);
        Py_XDECREF(rv);
        Py_XDECREF(nd);
        Py_XDECREF(nmeta);
        Py_XDECREF(nspec);
        if (!ok) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, i, dst);
    }
    return out;
}

/* ---- the store's ordered publish (ObjectStore._install_shard) ---- */

/* publish_shard(objs, infl, kind, shard, news) -> (entries, pairs)
 *
 * The loop of ObjectStore._install_shard in one call: install news[i]
 * under shard[i]'s key, release the key from the in-flight set, and build
 * the journal entries [(rv, "MODIFIED", kind, new)] (rv read from
 * new.metadata.resource_version) and the delivery pairs [(old, new)]. The
 * caller holds the store's lock and lands the entries through one
 * sequencer call. */
static PyObject *
publish_shard(PyObject *self, PyObject *args)
{
    PyObject *objs, *infl, *kind, *shard, *news;
    if (!PyArg_ParseTuple(args, "O!O!UO!O!", &PyDict_Type, &objs,
                          &PySet_Type, &infl, &kind, &PyList_Type, &shard,
                          &PyList_Type, &news))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(shard);
    if (PyList_GET_SIZE(news) != n) {
        PyErr_SetString(PyExc_ValueError, "shard/news length mismatch");
        return NULL;
    }
    PyObject *entries = PyList_New(n);
    PyObject *pairs = PyList_New(n);
    if (entries == NULL || pairs == NULL)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PyList_GET_ITEM(shard, i);
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) < 2) {
            PyErr_SetString(PyExc_TypeError,
                            "shard items must be (key, old, ...) tuples");
            goto fail;
        }
        PyObject *key = PyTuple_GET_ITEM(item, 0);
        PyObject *old = PyTuple_GET_ITEM(item, 1);
        PyObject *new = PyList_GET_ITEM(news, i);
        PyObject *meta = dict_attr(new, s_metadata);
        PyObject *rv = meta == NULL ? NULL
            : dict_attr(meta, s_resource_version);
        if (rv == NULL) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_TypeError,
                                "object lacks metadata.resource_version");
            goto fail;
        }
        if (PyDict_SetItem(objs, key, new) < 0)
            goto fail;
        if (PySet_Discard(infl, key) < 0)
            goto fail;
        PyObject *entry = PyTuple_Pack(4, rv, s_modified, kind, new);
        if (entry == NULL)
            goto fail;
        PyList_SET_ITEM(entries, i, entry);
        PyObject *pair = PyTuple_Pack(2, old, new);
        if (pair == NULL)
            goto fail;
        PyList_SET_ITEM(pairs, i, pair);
    }
    return Py_BuildValue("(NN)", entries, pairs);
fail:
    Py_XDECREF(entries);
    Py_XDECREF(pairs);
    return NULL;
}

/* ---- the cache's bind-echo ingest (update_pods_bulk's own-write path) ---- */

static PyObject *s_status_version, *s_tasks, *s_task_status_index, *s_queue;

/* bind_echo_apply(pairs, start, exp, jobs, nodes, confirms) -> int
 *
 * The own-write branch of EventHandlersMixin.update_pods_bulk over
 * pairs[start:], pair by pair: a pair whose new.metadata.uid the
 * expected-bind-echo map exp names (task, host) passes when the job is
 * cached, new.spec.node_name and task.node_name are the host and the
 * task's status and the echo's (get_task_status) are both allocated.
 * Then, as the Python body does: the confirm of (task key, job queue) is
 * appended to confirms (None: the ledger is off), merging into the last
 * run when its queue is equal; JobInfo.move_task_status(task, status)
 * runs (the status version bumped, the index entry moved; both statuses
 * are allocated and neither is Pending, so no Resource moves); the
 * task's pod takes the echo's resource_version; and the node's stored
 * view of the task takes the status and, on a pod of its own, the
 * resource_version.
 *
 * Returns the index of the first pair not taken, len(pairs) when all
 * were: a designed hand-back. The caller runs that pair through the
 * Python body (its guards decline it the same way, or it takes another
 * path: another writer's patch, a task the job no longer holds as this
 * object) and calls again from the next one, so every pair is handled
 * in delivery order. The caller holds the cache's mutex. */
static PyObject *
bind_echo_apply(PyObject *self, PyObject *args)
{
    PyObject *pairs, *exp, *jobs, *nodes, *confirms;
    Py_ssize_t start;
    if (!PyArg_ParseTuple(args, "O!nO!O!O!O", &PyList_Type, &pairs, &start,
                          &PyDict_Type, &exp, &PyDict_Type, &jobs,
                          &PyDict_Type, &nodes, &confirms))
        return NULL;
    if (task_type == NULL || ts_allocated_set == NULL) {
        PyErr_SetString(PyExc_RuntimeError,
                        "task type/status members not registered");
        return NULL;
    }
    if (confirms != Py_None && !PyList_Check(confirms)) {
        PyErr_SetString(PyExc_TypeError, "confirms must be a list or None");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(pairs);
    Py_ssize_t i = start < 0 ? 0 : start;
    for (; i < n; i++) {
        PyObject *pair = PyList_GET_ITEM(pairs, i);
        if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2)
            break;
        /* ---- the guards: every check before the first change ---- */
        PyObject *nd = dict_of(PyTuple_GET_ITEM(pair, 1));
        PyObject *meta = nd == NULL ? NULL
            : PyDict_GetItemWithError(nd, s_metadata);
        PyObject *spec = nd == NULL ? NULL
            : PyDict_GetItemWithError(nd, s_spec);
        PyObject *uid = meta == NULL ? NULL : dict_attr(meta, s_uid);
        PyObject *own = uid == NULL ? NULL
            : PyDict_GetItemWithError(exp, uid);
        if (PyErr_Occurred())
            return NULL;
        if (spec == NULL || own == NULL || !PyTuple_Check(own)
                || PyTuple_GET_SIZE(own) != 2)
            break;
        PyObject *task = PyTuple_GET_ITEM(own, 0);
        PyObject *host = PyTuple_GET_ITEM(own, 1);
        if (!PyObject_TypeCheck(task, task_type))
            break;
        PyObject *new_status = task_status_of(nd, meta, spec);
        if (new_status == NULL) {
            if (PyErr_Occurred())
                return NULL;
            break;
        }
        PyObject *jid = TASK_SLOT(task, t_job_off);
        PyObject *job = jid == NULL ? NULL
            : PyDict_GetItemWithError(jobs, jid);
        if (job == NULL) {
            if (PyErr_Occurred())
                return NULL;
            break;
        }
        PyObject *old = TASK_SLOT(task, status_offset);
        PyObject *tnn = TASK_SLOT(task, t_node_name_off);
        if (!str_eq(dict_attr(spec, s_node_name), host)
                || !str_eq(tnn, host) || old == NULL
                || PySet_Contains(ts_allocated_set, old) != 1
                || PySet_Contains(ts_allocated_set, new_status) != 1) {
            if (PyErr_Occurred())
                return NULL;
            break;
        }
        /* the shapes the fixed sequence below writes through */
        PyObject *jd = dict_of(job);
        PyObject *jtasks = jd == NULL ? NULL
            : PyDict_GetItemWithError(jd, s_tasks);
        PyObject *tsi = jd == NULL ? NULL
            : PyDict_GetItemWithError(jd, s_task_status_index);
        PyObject *sv = jd == NULL ? NULL
            : PyDict_GetItemWithError(jd, s_status_version);
        PyObject *queue = jd == NULL || confirms == Py_None ? NULL
            : PyDict_GetItemWithError(jd, s_queue);
        PyObject *tuid = TASK_SLOT(task, uid_offset);
        PyObject *key = TASK_SLOT(task, t_key_off);
        PyObject *rv = dict_attr(meta, s_resource_version);
        PyObject *pod = TASK_SLOT(task, t_pod_off);
        PyObject *pmeta = pod == NULL ? NULL : dict_attr(pod, s_metadata);
        PyObject *pmd = pmeta == NULL ? NULL : dict_of(pmeta);
        if (PyErr_Occurred())
            return NULL;
        if (jtasks == NULL || !PyDict_Check(jtasks) || tsi == NULL
                || !PyDict_Check(tsi) || sv == NULL || !PyLong_CheckExact(sv)
                || (confirms != Py_None && queue == NULL) || tuid == NULL
                || key == NULL || rv == NULL || pmd == NULL)
            break;
        PyObject *held = PyDict_GetItemWithError(jtasks, tuid);
        if (held != task) {
            if (PyErr_Occurred())
                return NULL;
            break;   /* move_task_status would move another object */
        }
        PyObject *node = tnn == NULL ? NULL
            : PyDict_GetItemWithError(nodes, tnn);
        PyObject *ntasks = node == NULL ? NULL : dict_attr(node, s_tasks);
        if (PyErr_Occurred())
            return NULL;
        if (node != NULL && (ntasks == NULL || !PyDict_Check(ntasks)))
            break;
        PyObject *stored = ntasks == NULL ? NULL
            : PyDict_GetItemWithError(ntasks, key);
        if (PyErr_Occurred())
            return NULL;
        PyObject *smd = NULL;
        if (stored != NULL && stored != task) {
            if (!PyObject_TypeCheck(stored, task_type))
                break;
            PyObject *spod = TASK_SLOT(stored, t_pod_off);
            if (spod != pod) {
                PyObject *smeta = spod == NULL ? NULL
                    : dict_attr(spod, s_metadata);
                smd = smeta == NULL ? NULL : dict_of(smeta);
                if (smd == NULL) {
                    if (PyErr_Occurred())
                        return NULL;
                    break;
                }
            }
        }
        /* ---- the changes, in the Python body's order ---- */
        if (confirms != Py_None) {
            Py_ssize_t nc = PyList_GET_SIZE(confirms);
            PyObject *last = nc == 0 ? NULL
                : PyList_GET_ITEM(confirms, nc - 1);
            int same = 0;
            if (last != NULL) {
                if (!PyTuple_Check(last) || PyTuple_GET_SIZE(last) != 2
                        || !PyList_Check(PyTuple_GET_ITEM(last, 0))) {
                    PyErr_SetString(PyExc_TypeError,
                                    "confirms items must be (keys, queue)");
                    return NULL;
                }
                same = PyObject_RichCompareBool(PyTuple_GET_ITEM(last, 1),
                                                queue, Py_EQ);
                if (same < 0)
                    return NULL;
            }
            if (same) {
                if (PyList_Append(PyTuple_GET_ITEM(last, 0), key) < 0)
                    return NULL;
            } else {
                PyObject *run = Py_BuildValue("([O]O)", key, queue);
                if (run == NULL)
                    return NULL;
                int rc = PyList_Append(confirms, run);
                Py_DECREF(run);
                if (rc < 0)
                    return NULL;
            }
        }
        PyObject *nv = PyLong_FromLongLong(PyLong_AsLongLong(sv) + 1);
        if (nv == NULL)
            return NULL;
        int rc = PyDict_SetItem(jd, s_status_version, nv);
        Py_DECREF(nv);
        if (rc < 0)
            return NULL;
        PyObject *old_idx = PyDict_GetItemWithError(tsi, old);
        if (old_idx != NULL && PyDict_Check(old_idx)) {
            Py_INCREF(old_idx);
            if (PyDict_DelItem(old_idx, tuid) < 0) {
                if (!PyErr_ExceptionMatches(PyExc_KeyError)) {
                    Py_DECREF(old_idx);
                    return NULL;
                }
                PyErr_Clear();                     /* pop(uid, None) */
            }
            rc = PyDict_GET_SIZE(old_idx) == 0 ? PyDict_DelItem(tsi, old)
                                               : 0;
            Py_DECREF(old_idx);
            if (rc < 0)
                return NULL;
        } else if (PyErr_Occurred())
            return NULL;
        PyObject *new_idx = PyDict_GetItemWithError(tsi, new_status);
        if (new_idx == NULL) {
            if (PyErr_Occurred())
                return NULL;
            new_idx = PyDict_New();       /* the defaultdict's bucket */
            if (new_idx == NULL)
                return NULL;
            rc = PyDict_SetItem(tsi, new_status, new_idx);
            Py_DECREF(new_idx);           /* tsi holds it */
            if (rc < 0)
                return NULL;
        }
        slot_store(task, status_offset, new_status);
        if (PyDict_SetItem(jtasks, tuid, task) < 0
                || PyDict_SetItem(new_idx, tuid, task) < 0
                || PyDict_SetItem(pmd, s_resource_version, rv) < 0)
            return NULL;
        if (stored != NULL && stored != task) {
            slot_store(stored, status_offset, new_status);
            if (smd != NULL
                    && PyDict_SetItem(smd, s_resource_version, rv) < 0)
                return NULL;
        }
    }
    return PyLong_FromSsize_t(i);
}
/* job._status_version += 1 (move_tasks_status_bulk's one bump a job) */
static int
bump_status_version(PyObject *jd)
{
    PyObject *sv = PyDict_GetItemWithError(jd, s_status_version);
    if (sv == NULL)
        return PyErr_Occurred() ? -1 : 0;
    if (!PyLong_Check(sv))
        return 0;
    PyObject *nv = PyLong_FromLongLong(PyLong_AsLongLong(sv) + 1);
    if (nv == NULL)
        return -1;
    int rc = PyDict_SetItem(jd, s_status_version, nv);
    Py_DECREF(nv);
    return rc;
}

/* ---- native lifecycle-ledger completion (trace/ledger.confirm_runs:
 * the 50k-per-flush bind-echo completion loop) ---- */

static PyTypeObject *entry_type = NULL, *agg_type = NULL;
static Py_ssize_t e_stamps_off = -1, e_detours_off = -1, e_trace_off = -1,
    e_queue_off = -1;
static Py_ssize_t a_count_off = -1, a_total_off = -1, a_samples_off = -1;
static PyObject *hop_table = NULL;   /* ledger._HOP_NAME (list of lists) */
static long commit_idx = -1, echo_idx = -1;
static PyObject *s_append, *s_hop, *s_queue_label;

/* register_ledger_types(_Entry, _Agg, hop_table, commit_idx, echo_idx) */
static PyObject *
register_ledger_types(PyObject *self, PyObject *args)
{
    PyObject *etp, *atp, *table;
    long ci, ei;
    if (!PyArg_ParseTuple(args, "OOO!ll", &etp, &atp, &PyList_Type,
                          &table, &ci, &ei))
        return NULL;
    if (!PyType_Check(etp) || !PyType_Check(atp)) {
        PyErr_SetString(PyExc_TypeError, "expected types");
        return NULL;
    }
    Py_ssize_t so = member_offset((PyTypeObject *)etp, "stamps");
    Py_ssize_t dto = member_offset((PyTypeObject *)etp, "detours");
    Py_ssize_t tro = member_offset((PyTypeObject *)etp, "trace");
    Py_ssize_t qo = member_offset((PyTypeObject *)etp, "queue");
    Py_ssize_t co = member_offset((PyTypeObject *)atp, "count");
    Py_ssize_t to = member_offset((PyTypeObject *)atp, "total");
    Py_ssize_t smo = member_offset((PyTypeObject *)atp, "samples");
    if (so < 0 || dto < 0 || tro < 0 || qo < 0 || co < 0 || to < 0
            || smo < 0)
        return NULL;
    e_stamps_off = so; e_detours_off = dto; e_trace_off = tro;
    e_queue_off = qo;
    a_count_off = co; a_total_off = to; a_samples_off = smo;
    Py_INCREF(etp);
    Py_XDECREF((PyObject *)entry_type);
    entry_type = (PyTypeObject *)etp;
    Py_INCREF(atp);
    Py_XDECREF((PyObject *)agg_type);
    agg_type = (PyTypeObject *)atp;
    Py_INCREF(table);
    Py_XDECREF(hop_table);
    hop_table = table;
    commit_idx = ci;
    echo_idx = ei;
    Py_RETURN_NONE;
}

/* one aggregate sink: the _Agg plus its cached deque-append bound
 * method and its staged-export list */
typedef struct {
    PyObject *agg;      /* borrowed (held by _hops/_queue_e2e) */
    PyObject *append;   /* owned bound method */
    PyObject *exports;  /* borrowed (held by _pending_exports) */
} sink_t;

/* agg.count += 1; agg.total += ms; agg.samples.append(ms);
 * exports.append(ms) — the exact _Agg.add + export staging sequence */
static int
sink_add(sink_t *s, double ms)
{
    PyObject **cp = (PyObject **)((char *)s->agg + a_count_off);
    PyObject *nv = PyLong_FromLongLong(PyLong_AsLongLong(*cp) + 1);
    if (nv == NULL)
        return -1;
    Py_DECREF(*cp);
    *cp = nv;
    PyObject **tp = (PyObject **)((char *)s->agg + a_total_off);
    nv = PyFloat_FromDouble(PyFloat_AS_DOUBLE(*tp) + ms);
    if (nv == NULL)
        return -1;
    Py_DECREF(*tp);
    *tp = nv;
    PyObject *msv = PyFloat_FromDouble(ms);
    if (msv == NULL)
        return -1;
    PyObject *r = PyObject_CallOneArg(s->append, msv);
    if (r == NULL) {
        Py_DECREF(msv);
        return -1;
    }
    Py_DECREF(r);
    int rc = 0;
    if (s->exports != NULL)
        rc = PyList_Append(s->exports, msv);
    Py_DECREF(msv);
    return rc;
}

/* resolve (or create) the _Agg in aggs[name] and its export list in
 * pending[_export_keys[label_key]]; label_kind/label_value build the
 * export key tuple (metric, ((label_kind, label_value),)). */
static int
sink_resolve(sink_t *s, PyObject *aggs, PyObject *name, PyObject *pending,
             PyObject *ekeys, PyObject *metric, PyObject *label_kind,
             PyObject *label_value, PyObject *ekey_probe)
{
    s->agg = NULL;
    s->append = NULL;
    s->exports = NULL;
    PyObject *agg = PyDict_GetItemWithError(aggs, name);
    if (agg == NULL) {
        if (PyErr_Occurred())
            return -1;
        agg = PyObject_CallNoArgs((PyObject *)agg_type);
        if (agg == NULL || PyDict_SetItem(aggs, name, agg) < 0) {
            Py_XDECREF(agg);
            return -1;
        }
        Py_DECREF(agg);   /* aggs holds it */
    }
    if (Py_TYPE(agg) != agg_type) {
        PyErr_SetString(PyExc_TypeError, "unexpected aggregate type");
        return -1;
    }
    s->agg = agg;
    PyObject *samples = *(PyObject **)((char *)agg + a_samples_off);
    if (samples == NULL) {
        PyErr_SetString(PyExc_TypeError, "aggregate lacks samples");
        return -1;
    }
    s->append = PyObject_GetAttr(samples, s_append);
    if (s->append == NULL)
        return -1;
    if (pending == NULL)
        return 0;   /* exports disabled (no metric plumbed) */
    PyObject *ek = PyDict_GetItemWithError(ekeys, ekey_probe);
    if (ek == NULL) {
        if (PyErr_Occurred())
            return -1;
        PyObject *label = Py_BuildValue("((OO))", label_kind, label_value);
        if (label == NULL)
            return -1;
        ek = Py_BuildValue("(ON)", metric, label);
        if (ek == NULL || PyDict_SetItem(ekeys, ekey_probe, ek) < 0) {
            Py_XDECREF(ek);
            return -1;
        }
        Py_DECREF(ek);
        ek = PyDict_GetItem(ekeys, ekey_probe);
    }
    PyObject *lst = PyDict_GetItemWithError(pending, ek);
    if (lst == NULL) {
        if (PyErr_Occurred())
            return -1;
        lst = PyList_New(0);
        if (lst == NULL || PyDict_SetItem(pending, ek, lst) < 0) {
            Py_XDECREF(lst);
            return -1;
        }
        Py_DECREF(lst);
        lst = PyDict_GetItem(pending, ek);
    }
    s->exports = lst;
    return 0;
}

/* ledger_confirm_runs(entries, hops, queue_e2e, pending, ekeys, recent,
 *                     hop_metric, e2e_metric, runs, commit_t, echo_t)
 *     -> completed count
 *
 * The bind-echo completion loop of trace/ledger.confirm_runs in C:
 * for every key still open, stamp store_committed @commit_t (unless
 * already stamped) and echo_confirmed @echo_t, aggregate every hop +
 * the e2e into the hop/queue aggregates, stage the prometheus exports
 * and the recent-completions ring entry, and retire the entry. The
 * caller holds the ledger lock; arithmetic is the exact per-pod
 * sequence of the Python loop (fingerprints must not see which ran). */
static PyObject *
ledger_confirm_runs(PyObject *self, PyObject *args)
{
    PyObject *entries, *hops, *queue_e2e, *pending, *ekeys, *recent;
    PyObject *hop_metric, *e2e_metric, *runs;
    double commit_t, echo_t;
    if (!PyArg_ParseTuple(args, "O!O!O!O!O!OOOO!dd",
                          &PyDict_Type, &entries, &PyDict_Type, &hops,
                          &PyDict_Type, &queue_e2e, &PyDict_Type, &pending,
                          &PyDict_Type, &ekeys, &recent,
                          &hop_metric, &e2e_metric, &PyList_Type, &runs,
                          &commit_t, &echo_t))
        return NULL;
    if (entry_type == NULL || agg_type == NULL || hop_table == NULL) {
        PyErr_SetString(PyExc_RuntimeError, "ledger types not registered");
        return NULL;
    }
    long completed = 0;
    PyObject *recent_append = PyObject_GetAttr(recent, s_append);
    if (recent_append == NULL)
        return NULL;
    /* per-call sink caches: hop name -> sink, plus the e2e + queue
     * sinks (queue constant per run) */
    PyObject *sink_keys = PyList_New(0);   /* keeps append refs alive */
    /* 7 stages -> at most 21 distinct hop names; 24 is unreachable */
    sink_t hop_sinks[24];
    PyObject *hop_names[24];
    int n_hop_sinks = 0;
    sink_t e2e_sink = {NULL, NULL, NULL};
    PyObject *e2e_name = PyUnicode_InternFromString("e2e");
    if (sink_keys == NULL || e2e_name == NULL)
        goto fail;
    if (sink_resolve(&e2e_sink, hops, e2e_name, NULL, NULL, NULL, NULL,
                     NULL, NULL) < 0)
        goto fail;
    if (PyList_Append(sink_keys, e2e_sink.append) < 0) {
        Py_DECREF(e2e_sink.append);
        goto fail;
    }
    Py_DECREF(e2e_sink.append);   /* sink_keys holds it */
    Py_ssize_t nr = PyList_GET_SIZE(runs);
    for (Py_ssize_t r = 0; r < nr; r++) {
        PyObject *run = PyList_GET_ITEM(runs, r);
        if (!PyTuple_Check(run) || PyTuple_GET_SIZE(run) != 2) {
            PyErr_SetString(PyExc_TypeError, "runs items must be 2-tuples");
            goto fail;
        }
        PyObject *keys = PyTuple_GET_ITEM(run, 0);
        PyObject *queue = PyTuple_GET_ITEM(run, 1);
        if (!PyList_Check(keys)) {
            PyErr_SetString(PyExc_TypeError, "run keys must be a list");
            goto fail;
        }
        PyObject *q = (queue == Py_None || queue == NULL)
            ? PyUnicode_InternFromString("") : (Py_INCREF(queue), queue);
        if (q == NULL)
            goto fail;
        sink_t q_sink;
        PyObject *probe = Py_BuildValue("(sO)", "q", q);
        if (probe == NULL) {
            Py_DECREF(q);
            goto fail;
        }
        int rc = sink_resolve(&q_sink, queue_e2e, q, pending, ekeys,
                              e2e_metric, s_queue_label, q, probe);
        Py_DECREF(probe);
        if (rc < 0) {
            Py_DECREF(q);
            goto fail;
        }
        if (PyList_Append(sink_keys, q_sink.append) < 0) {
            Py_DECREF(q);
            Py_DECREF(q_sink.append);
            goto fail;
        }
        Py_DECREF(q_sink.append);   /* sink_keys holds it */
        Py_ssize_t nk = PyList_GET_SIZE(keys);
        for (Py_ssize_t ki = 0; ki < nk; ki++) {
            PyObject *key = PyList_GET_ITEM(keys, ki);
            PyObject *e = PyDict_GetItemWithError(entries, key);
            if (e == NULL) {
                if (PyErr_Occurred()) {
                    Py_DECREF(q);
                    goto fail;
                }
                continue;
            }
            if (Py_TYPE(e) != entry_type) {
                Py_DECREF(q);
                PyErr_SetString(PyExc_TypeError, "unexpected entry type");
                goto fail;
            }
            PyObject *stamps = *(PyObject **)((char *)e + e_stamps_off);
            if (stamps == NULL || !PyList_Check(stamps)) {
                Py_DECREF(q);
                PyErr_SetString(PyExc_TypeError, "entry lacks stamps");
                goto fail;
            }
            Py_ssize_t ns = PyList_GET_SIZE(stamps);
            long last_i = -1;
            double last_t = 0.0;
            if (ns > 0) {
                PyObject *last = PyList_GET_ITEM(stamps, ns - 1);
                last_i = PyLong_AsLong(PyTuple_GET_ITEM(last, 0));
                last_t = PyFloat_AsDouble(PyTuple_GET_ITEM(last, 1));
                if (PyErr_Occurred()) {
                    Py_DECREF(q);
                    goto fail;
                }
            }
            if (last_i >= echo_idx)
                continue;
            if (queue != Py_None && queue != NULL)
                slot_store(e, e_queue_off, queue);
            /* the virtual commit/echo stamps (appended by the Python
             * loop; computed in place here) */
            double tc = 0.0;
            int have_commit = 0;
            if (last_i < commit_idx) {
                tc = commit_t >= last_t ? commit_t : last_t;
                have_commit = 1;
            }
            double base = have_commit ? tc : last_t;
            double te = echo_t >= base ? echo_t : base;
            double t0 = ns > 0
                ? PyFloat_AsDouble(PyTuple_GET_ITEM(
                      PyList_GET_ITEM(stamps, 0), 1))
                : (have_commit ? tc : te);
            if (PyErr_Occurred()) {
                Py_DECREF(q);
                goto fail;
            }
            double e2e_ms = (te - t0) * 1000.0;
            PyObject *hop_list = PyList_New(0);
            if (hop_list == NULL) {
                Py_DECREF(q);
                goto fail;
            }
            /* walk: existing stamp pairs, then ->commit, then ->echo */
            long prev_i = -1;
            double prev_t = 0.0;
            int first = 1;
            int ok = 1;
            for (Py_ssize_t si = 0; ok && si <= ns + 1; si++) {
                long i1;
                double t1;
                if (si < ns) {
                    PyObject *st = PyList_GET_ITEM(stamps, si);
                    i1 = PyLong_AsLong(PyTuple_GET_ITEM(st, 0));
                    t1 = PyFloat_AsDouble(PyTuple_GET_ITEM(st, 1));
                    if (PyErr_Occurred()) {
                        ok = 0;
                        break;
                    }
                } else if (si == ns) {
                    if (!have_commit)
                        continue;
                    i1 = commit_idx;
                    t1 = tc;
                } else {
                    i1 = echo_idx;
                    t1 = te;
                }
                if (first) {
                    first = 0;
                    prev_i = i1;
                    prev_t = t1;
                    continue;
                }
                PyObject *hop = PyList_GET_ITEM(
                    PyList_GET_ITEM(hop_table, prev_i), i1);
                double ms = (t1 - prev_t) * 1000.0;
                prev_i = i1;
                prev_t = t1;
                sink_t *hs = NULL;
                for (int h = 0; h < n_hop_sinks; h++)
                    if (hop_names[h] == hop) {
                        hs = &hop_sinks[h];
                        break;
                    }
                if (hs == NULL) {
                    if (n_hop_sinks >= 24) {
                        PyErr_SetString(PyExc_RuntimeError,
                                        "too many hop kinds");
                        ok = 0;
                        break;
                    }
                    hs = &hop_sinks[n_hop_sinks];
                    if (sink_resolve(hs, hops, hop, pending, ekeys,
                                     hop_metric, s_hop, hop, hop) < 0) {
                        ok = 0;
                        break;
                    }
                    if (PyList_Append(sink_keys, hs->append) < 0) {
                        Py_DECREF(hs->append);
                        ok = 0;
                        break;
                    }
                    Py_DECREF(hs->append);
                    hop_names[n_hop_sinks++] = hop;
                }
                PyObject *pair = Py_BuildValue("(Od)", hop, ms);
                if (pair == NULL || PyList_Append(hop_list, pair) < 0) {
                    Py_XDECREF(pair);
                    ok = 0;
                    break;
                }
                Py_DECREF(pair);
                if (sink_add(hs, ms) < 0) {
                    ok = 0;
                    break;
                }
            }
            if (!ok) {
                Py_DECREF(hop_list);
                Py_DECREF(q);
                goto fail;
            }
            if (sink_add(&e2e_sink, e2e_ms) < 0
                    || sink_add(&q_sink, e2e_ms) < 0) {
                Py_DECREF(hop_list);
                Py_DECREF(q);
                goto fail;
            }
            PyObject *trace = *(PyObject **)((char *)e + e_trace_off);
            PyObject *detours = *(PyObject **)((char *)e + e_detours_off);
            PyObject *rec = Py_BuildValue(
                "(OOOdOO)", key, trace == NULL ? Py_None : trace, q,
                e2e_ms, hop_list,
                detours == NULL ? Py_None : detours);
            Py_DECREF(hop_list);
            if (rec == NULL) {
                Py_DECREF(q);
                goto fail;
            }
            PyObject *rr = PyObject_CallOneArg(recent_append, rec);
            Py_DECREF(rec);
            if (rr == NULL) {
                Py_DECREF(q);
                goto fail;
            }
            Py_DECREF(rr);
            if (PyDict_DelItem(entries, key) < 0) {
                Py_DECREF(q);
                goto fail;
            }
            completed++;
        }
        Py_DECREF(q);
    }
    Py_DECREF(recent_append);
    Py_DECREF(sink_keys);
    Py_XDECREF(e2e_name);
    return PyLong_FromLong(completed);
fail:
    Py_DECREF(recent_append);
    Py_XDECREF(sink_keys);
    Py_XDECREF(e2e_name);
    return NULL;
}
/* ---- native bind APPLY (the _BindBurst status-move + node accounting
 * pass of cache._apply_bind_bursts) ---- */

static PyObject *s_pairs, *s_accepted, *s_bound, *s_idle, *s_used,
    *s_name, *s_node, *s_gpu_devices, *s_allocated, *s_pending_request,
    *s_namespace_str;

#define RES_DBL(r, off) PyFloat_AS_DOUBLE(*(PyObject **)((char *)(r) + (off)))
#define RES_OBJ(r, off) (*(PyObject **)((char *)(r) + (off)))

static inline int
le_eps(double l, double r, double eps)
{
    return l < r || fabs(l - r) < eps;
}

/* accumulate src (a Resource.scalars dict) into *accp, creating the
 * accumulator dict lazily — the C twin of Resource.add's scalar loop
 * against a fresh Resource (same name insertion order, same float-add
 * order) */
static int
acc_scalars(PyObject **accp, PyObject *src)
{
    if (src == NULL || !PyDict_Check(src) || PyDict_GET_SIZE(src) == 0)
        return 0;
    if (*accp == NULL) {
        *accp = PyDict_New();
        if (*accp == NULL)
            return -1;
    }
    Py_ssize_t pos = 0;
    PyObject *name, *val;
    while (PyDict_Next(src, &pos, &name, &val)) {
        if (!PyFloat_Check(val))
            return -2;   /* unexpected shape: the caller hands back */
        PyObject *cur = PyDict_GetItemWithError(*accp, name);
        if (cur == NULL && PyErr_Occurred())
            return -1;
        double d = (cur == NULL ? 0.0 : PyFloat_AS_DOUBLE(cur))
            + PyFloat_AS_DOUBLE(val);
        PyObject *nv = PyFloat_FromDouble(d);
        if (nv == NULL || PyDict_SetItem(*accp, name, nv) < 0) {
            Py_XDECREF(nv);
            return -1;
        }
        Py_DECREF(nv);
    }
    return 0;
}

/* acc_scalars for the mutation phase, where validation already proved
 * every scalars dict float-valued: any failure is a real error */
static int
acc_scalars_strict(PyObject **accp, PyObject *src)
{
    int rc = acc_scalars(accp, src);
    if (rc == -2)
        PyErr_SetString(PyExc_TypeError, "non-float resource scalar");
    return rc ? -1 : 0;
}

/* total(acc) <= res within EPS under Zero defaults — the C twin of
 * Resource.less_equal(res, ZERO) for an accumulated (tcpu, tmem, tsc)
 * left side. 1 yes, 0 no, -1 error. */
static int
le_eps_resource(double tcpu, double tmem, PyObject *tsc, PyObject *res,
                double eps)
{
    if (!le_eps(tcpu, RES_DBL(res, res_cpu_offset), eps)
            || !le_eps(tmem, RES_DBL(res, res_mem_offset), eps))
        return 0;
    PyObject *rsc = RES_OBJ(res, res_scalars_offset);
    int t_empty = tsc == NULL || PyDict_GET_SIZE(tsc) == 0;
    int r_empty = rsc == NULL || !PyDict_Check(rsc)
        || PyDict_GET_SIZE(rsc) == 0;
    if (t_empty && r_empty)
        return 1;
    Py_ssize_t pos = 0;
    PyObject *name, *val;
    if (!t_empty) {
        while (PyDict_Next(tsc, &pos, &name, &val)) {
            double l = PyFloat_AS_DOUBLE(val);
            PyObject *rv = r_empty ? NULL
                : PyDict_GetItemWithError(rsc, name);
            if (rv == NULL && PyErr_Occurred())
                return -1;
            double r = rv == NULL ? 0.0
                : (PyFloat_Check(rv) ? PyFloat_AS_DOUBLE(rv) : -1.0);
            if (rv != NULL && !PyFloat_Check(rv))
                return -1;
            if (isinf(r) && r > 0)
                continue;
            if ((isinf(l) && l > 0) || !le_eps(l, r, eps))
                return 0;
        }
    }
    if (!r_empty) {
        pos = 0;
        while (PyDict_Next(rsc, &pos, &name, &val)) {
            if (!t_empty) {
                PyObject *lv = PyDict_GetItemWithError(tsc, name);
                if (lv == NULL && PyErr_Occurred())
                    return -1;
                if (lv != NULL)
                    continue;   /* already compared above */
            }
            if (!PyFloat_Check(val))
                return -1;
            double r = PyFloat_AS_DOUBLE(val);
            if (isinf(r) && r > 0)
                continue;
            if (!le_eps(0.0, r, eps))
                return 0;
        }
    }
    return 1;
}

/* res.milli_cpu/memory += (or -=) the accumulated deltas; scalars follow
 * Resource.add's (always iterate rr) / sub_unchecked's (skip when self
 * empty) semantics via the add_semantics flag */
static int
apply_res_delta(PyObject *res, double dcpu, double dmem, PyObject *dsc,
                int sign, int add_semantics)
{
    PyObject *nv = PyFloat_FromDouble(
        RES_DBL(res, res_cpu_offset) + sign * dcpu);
    if (nv == NULL)
        return -1;
    PyObject **slot = (PyObject **)((char *)res + res_cpu_offset);
    Py_DECREF(*slot);
    *slot = nv;
    nv = PyFloat_FromDouble(RES_DBL(res, res_mem_offset) + sign * dmem);
    if (nv == NULL)
        return -1;
    slot = (PyObject **)((char *)res + res_mem_offset);
    Py_DECREF(*slot);
    *slot = nv;
    if (dsc == NULL || PyDict_GET_SIZE(dsc) == 0)
        return 0;
    PyObject *rsc = RES_OBJ(res, res_scalars_offset);
    if (rsc == NULL || !PyDict_Check(rsc))
        return -1;
    if (!add_semantics && PyDict_GET_SIZE(rsc) == 0)
        return 0;   /* sub_unchecked: `if not self.scalars: return` */
    Py_ssize_t pos = 0;
    PyObject *name, *val;
    while (PyDict_Next(dsc, &pos, &name, &val)) {
        PyObject *cur = PyDict_GetItemWithError(rsc, name);
        if (cur == NULL && PyErr_Occurred())
            return -1;
        double d = (cur == NULL ? 0.0 : PyFloat_AS_DOUBLE(cur))
            + sign * PyFloat_AS_DOUBLE(val);
        nv = PyFloat_FromDouble(d);
        if (nv == NULL || PyDict_SetItem(rsc, name, nv) < 0) {
            Py_XDECREF(nv);
            return -1;
        }
        Py_DECREF(nv);
    }
    return 0;
}

/* bind_apply_bursts(bursts, jobs, nodes, dirty_jobs, dirty_nodes,
 *                   binding, eps) -> bool
 *
 * The coalesced cross-gang bind apply in one C pass: group every
 * burst's (task_info, hostname) pairs by job, move the cached tasks to
 * Binding (status-index move + allocated/pending_request flips, one
 * status-version bump per job), then run ONE accounting pass per node
 * (idle/used update + task clone install) and populate each burst's
 * accepted/bound lists in (job-group, node-group) order — exactly the
 * Python _apply_bind_bursts sequence.
 *
 * All-or-nothing: a full validation pass runs FIRST (missing job/task/
 * node, node-name conflicts, duplicate keys, idle fit, GPU-sharing
 * nodes, unexpected shapes) and returns False with NOTHING mutated: a
 * designed hand-back, the caller then runs the Python body, which
 * handles every irregular case task by task. */
static PyObject *
bind_apply_bursts(PyObject *self, PyObject *args)
{
    PyObject *bursts, *jobs, *nodes, *dirty_jobs, *dirty_nodes, *binding;
    double eps;
    if (!PyArg_ParseTuple(args, "O!O!O!O!O!Od", &PyList_Type, &bursts,
                          &PyDict_Type, &jobs, &PyDict_Type, &nodes,
                          &PySet_Type, &dirty_jobs, &PySet_Type,
                          &dirty_nodes, &binding, &eps))
        return NULL;
    if (task_type == NULL || res_type == NULL || ts_allocated_set == NULL) {
        PyErr_SetString(PyExc_RuntimeError, "types not registered");
        return NULL;
    }
    PyObject *by_job = PyDict_New();    /* jid -> [(burst, ti, stored)] */
    PyObject *by_node = PyDict_New();   /* host -> [(burst, ti, stored)] */
    if (by_job == NULL || by_node == NULL)
        goto err;

    /* ---- grouping ---- */
    Py_ssize_t nb = PyList_GET_SIZE(bursts);
    for (Py_ssize_t b = 0; b < nb; b++) {
        PyObject *burst = PyList_GET_ITEM(bursts, b);
        PyObject *bpairs = PyObject_GetAttr(burst, s_pairs);
        if (bpairs == NULL || !PyList_Check(bpairs)) {
            Py_XDECREF(bpairs);
            goto hand_back;
        }
        Py_ssize_t np = PyList_GET_SIZE(bpairs);
        for (Py_ssize_t i = 0; i < np; i++) {
            PyObject *pr = PyList_GET_ITEM(bpairs, i);
            if (!PyTuple_Check(pr) || PyTuple_GET_SIZE(pr) != 2) {
                Py_DECREF(bpairs);
                goto hand_back;
            }
            PyObject *ti = PyTuple_GET_ITEM(pr, 0);
            PyObject *host = PyTuple_GET_ITEM(pr, 1);
            if (Py_TYPE(ti) != task_type) {
                Py_DECREF(bpairs);
                goto hand_back;
            }
            PyObject *jid = TASK_SLOT(ti, t_job_off);
            PyObject *lst = PyDict_GetItemWithError(by_job, jid);
            if (lst == NULL) {
                if (PyErr_Occurred()) {
                    Py_DECREF(bpairs);
                    goto err;
                }
                lst = PyList_New(0);
                if (lst == NULL
                        || PyDict_SetItem(by_job, jid, lst) < 0) {
                    Py_XDECREF(lst);
                    Py_DECREF(bpairs);
                    goto err;
                }
                Py_DECREF(lst);
            }
            PyObject *item = PyTuple_Pack(3, burst, ti, host);
            if (item == NULL || PyList_Append(lst, item) < 0) {
                Py_XDECREF(item);
                Py_DECREF(bpairs);
                goto err;
            }
            Py_DECREF(item);
        }
        Py_DECREF(bpairs);
    }

    /* ---- validation: resolve stored tasks + nodes, build by_node ---- */
    Py_ssize_t jpos = 0;
    PyObject *jid, *items;
    while (PyDict_Next(by_job, &jpos, &jid, &items)) {
        PyObject *job = PyDict_GetItemWithError(jobs, jid);
        if (job == NULL) {
            if (PyErr_Occurred())
                goto err;
            goto hand_back;
        }
        PyObject **jdp = _PyObject_GetDictPtr(job);
        if (jdp == NULL || *jdp == NULL)
            goto hand_back;
        PyObject *jtasks = PyDict_GetItemWithError(*jdp, s_tasks);
        PyObject *alloc = PyDict_GetItemWithError(*jdp, s_allocated);
        PyObject *pend = PyDict_GetItemWithError(*jdp, s_pending_request);
        PyObject *vtsi = PyDict_GetItemWithError(*jdp, s_task_status_index);
        if (jtasks == NULL || !PyDict_Check(jtasks) || alloc == NULL
                || Py_TYPE(alloc) != res_type || pend == NULL
                || Py_TYPE(pend) != res_type || vtsi == NULL
                || !PyDict_Check(vtsi)) {
            if (PyErr_Occurred())
                goto err;
            goto hand_back;
        }
        double p_cpu = 0.0, p_mem = 0.0;
        PyObject *p_sc = NULL;
        int p_any = 0;
        Py_ssize_t ni = PyList_GET_SIZE(items);
        for (Py_ssize_t i = 0; i < ni; i++) {
            PyObject *item = PyList_GET_ITEM(items, i);
            PyObject *ti = PyTuple_GET_ITEM(item, 1);
            PyObject *host = PyTuple_GET_ITEM(item, 2);
            PyObject *stored = PyDict_GetItemWithError(
                jtasks, TASK_SLOT(ti, uid_offset));
            if (stored == NULL || Py_TYPE(stored) != task_type) {
                Py_XDECREF(p_sc);
                if (PyErr_Occurred())
                    goto err;
                goto hand_back;
            }
            PyObject *node = PyDict_GetItemWithError(nodes, host);
            if (node == NULL) {
                Py_XDECREF(p_sc);
                if (PyErr_Occurred())
                    goto err;
                goto hand_back;
            }
            PyObject *resreq = TASK_SLOT(stored, t_resreq_off);
            if (resreq == NULL || Py_TYPE(resreq) != res_type
                    || !PyFloat_Check(RES_OBJ(resreq, res_cpu_offset))
                    || !PyFloat_Check(RES_OBJ(resreq, res_mem_offset))) {
                Py_XDECREF(p_sc);
                goto hand_back;
            }
            /* pending_request.sub() assert pre-check accumulation */
            PyObject *old = TASK_SLOT(stored, status_offset);
            if (old == ts_pending) {
                p_any = 1;
                p_cpu += RES_DBL(resreq, res_cpu_offset);
                p_mem += RES_DBL(resreq, res_mem_offset);
                int rc = acc_scalars(&p_sc,
                                     RES_OBJ(resreq, res_scalars_offset));
                if (rc == -1) {
                    Py_XDECREF(p_sc);
                    goto err;
                }
                if (rc == -2) {
                    Py_XDECREF(p_sc);
                    goto hand_back;
                }
            }
            /* stash (burst, ti, stored) under the node, and swap the
             * by_job item for the resolved 4-tuple the mutation pass
             * reads (index 3 = stored) */
            PyObject *nlst = PyDict_GetItemWithError(by_node, host);
            if (nlst == NULL) {
                if (PyErr_Occurred()) {
                    Py_XDECREF(p_sc);
                    goto err;
                }
                nlst = PyList_New(0);
                if (nlst == NULL
                        || PyDict_SetItem(by_node, host, nlst) < 0) {
                    Py_XDECREF(nlst);
                    Py_XDECREF(p_sc);
                    goto err;
                }
                Py_DECREF(nlst);
            }
            PyObject *nitem = PyTuple_Pack(
                3, PyTuple_GET_ITEM(item, 0), ti, stored);
            if (nitem == NULL || PyList_Append(nlst, nitem) < 0) {
                Py_XDECREF(nitem);
                Py_XDECREF(p_sc);
                goto err;
            }
            Py_DECREF(nitem);
            PyObject *ritem = PyTuple_Pack(
                4, PyTuple_GET_ITEM(item, 0), ti,
                PyTuple_GET_ITEM(item, 2), stored);
            if (ritem == NULL
                    || PyList_SetItem(items, i, ritem) < 0) {  /* steals */
                Py_XDECREF(ritem);
                Py_XDECREF(p_sc);
                goto err;
            }
        }
        if (p_any) {
            int ok = le_eps_resource(p_cpu, p_mem, p_sc, pend, eps);
            Py_XDECREF(p_sc);
            if (ok < 0)
                goto err;
            if (!ok)
                goto hand_back;   /* sub() would assert */
        } else
            Py_XDECREF(p_sc);
    }

    /* ---- validation: per-node accounting preconditions ---- */
    Py_ssize_t npos = 0;
    PyObject *host, *nitems;
    while (PyDict_Next(by_node, &npos, &host, &nitems)) {
        PyObject *node = PyDict_GetItem(nodes, host);   /* resolved above */
        PyObject **ndp = node == NULL ? NULL : _PyObject_GetDictPtr(node);
        if (ndp == NULL || *ndp == NULL)
            goto hand_back;
        PyObject *nd = *ndp;
        PyObject *gpus = PyDict_GetItemWithError(nd, s_gpu_devices);
        if (PyErr_Occurred())
            goto err;
        int truthy = gpus == NULL ? 0 : PyObject_IsTrue(gpus);
        if (truthy != 0)
            goto hand_back;   /* GPU-sharing nodes keep the Python path */
        PyObject *nname = PyDict_GetItemWithError(nd, s_name);
        PyObject *ntasks = PyDict_GetItemWithError(nd, s_tasks);
        PyObject *nodeobj = PyDict_GetItemWithError(nd, s_node);
        PyObject *idle = PyDict_GetItemWithError(nd, s_idle);
        PyObject *used = PyDict_GetItemWithError(nd, s_used);
        if (PyErr_Occurred())
            goto err;
        if (nname == NULL || ntasks == NULL || !PyDict_Check(ntasks)
                || idle == NULL || Py_TYPE(idle) != res_type
                || used == NULL || Py_TYPE(used) != res_type)
            goto hand_back;
        double t_cpu = 0.0, t_mem = 0.0;
        PyObject *t_sc = NULL;
        Py_ssize_t ni = PyList_GET_SIZE(nitems);
        int bad = 0;
        PyObject *seen = PySet_New(NULL);
        if (seen == NULL)
            goto err;
        for (Py_ssize_t i = 0; i < ni && !bad; i++) {
            PyObject *stored = PyTuple_GET_ITEM(
                PyList_GET_ITEM(nitems, i), 2);
            PyObject *tn = TASK_SLOT(stored, t_node_name_off);
            int tn_t = tn == NULL ? 0 : PyObject_IsTrue(tn);
            int nn_t = PyObject_IsTrue(nname);
            if (tn_t < 0 || nn_t < 0) {
                Py_DECREF(seen);
                Py_XDECREF(t_sc);
                goto err;
            }
            if (tn_t && nn_t && !str_eq(tn, nname)) {
                bad = 1;   /* already on a different node */
                break;
            }
            PyObject *key = TASK_SLOT(stored, t_key_off);
            if (key == NULL) {
                Py_DECREF(seen);
                Py_XDECREF(t_sc);
                PyErr_SetString(PyExc_TypeError, "task lacks key_cache");
                goto err;
            }
            Py_INCREF(key);
            int dup = PyDict_Contains(ntasks, key);
            int dup2 = dup == 0 ? PySet_Contains(seen, key) : dup;
            if (dup < 0 || dup2 < 0 || PySet_Add(seen, key) < 0) {
                Py_DECREF(key);
                Py_DECREF(seen);
                Py_XDECREF(t_sc);
                goto err;
            }
            Py_DECREF(key);
            if (dup || dup2) {
                bad = 1;
                break;
            }
            PyObject *resreq = TASK_SLOT(stored, t_resreq_off);
            t_cpu += RES_DBL(resreq, res_cpu_offset);
            t_mem += RES_DBL(resreq, res_mem_offset);
            int rc = acc_scalars(&t_sc,
                                 RES_OBJ(resreq, res_scalars_offset));
            if (rc == -1) {
                Py_DECREF(seen);
                Py_XDECREF(t_sc);
                goto err;
            }
            if (rc == -2)
                bad = 1;
        }
        Py_DECREF(seen);
        if (!bad && nodeobj != NULL && nodeobj != Py_None) {
            int fit = le_eps_resource(t_cpu, t_mem, t_sc, idle, eps);
            if (fit < 0) {
                Py_XDECREF(t_sc);
                goto err;
            }
            if (!fit)
                bad = 1;
        }
        Py_XDECREF(t_sc);
        if (bad)
            goto hand_back;
    }

    /* ---- mutation: per-job status moves + flips ---- */
    jpos = 0;
    while (PyDict_Next(by_job, &jpos, &jid, &items)) {
        if (PySet_Add(dirty_jobs, jid) < 0)
            goto err;
        PyObject *job = PyDict_GetItem(jobs, jid);
        PyObject *jd = *_PyObject_GetDictPtr(job);
        PyObject *jtasks = PyDict_GetItem(jd, s_tasks);
        PyObject *alloc = PyDict_GetItem(jd, s_allocated);
        PyObject *pend = PyDict_GetItem(jd, s_pending_request);
        PyObject *tsi = PyDict_GetItem(jd, s_task_status_index);  /* validated */
        if (bump_status_version(jd) < 0)
            goto err;
        /* new-status bucket up front, like move_tasks_status_bulk */
        PyObject *new_idx = PyDict_GetItemWithError(tsi, binding);
        if (new_idx == NULL) {
            if (PyErr_Occurred())
                goto err;
            new_idx = PyDict_New();
            if (new_idx == NULL
                    || PyDict_SetItem(tsi, binding, new_idx) < 0) {
                Py_XDECREF(new_idx);
                goto err;
            }
            Py_DECREF(new_idx);
            new_idx = PyDict_GetItem(tsi, binding);
        }
        double f_cpu = 0.0, f_mem = 0.0, p_cpu = 0.0, p_mem = 0.0;
        PyObject *f_sc = NULL, *p_sc = NULL;
        int f_any = 0, p_any = 0;
        Py_ssize_t ni = PyList_GET_SIZE(items);
        for (Py_ssize_t i = 0; i < ni; i++) {
            PyObject *stored = PyTuple_GET_ITEM(
                PyList_GET_ITEM(items, i), 3);   /* resolved 4-tuple */
            PyObject *uid = TASK_SLOT(stored, uid_offset);
            PyObject *old = TASK_SLOT(stored, status_offset);
            PyObject *old_idx = PyDict_GetItemWithError(tsi, old);
            if (old_idx != NULL && PyDict_Check(old_idx)) {
                if (PyDict_DelItem(old_idx, uid) < 0)
                    PyErr_Clear();
                if (PyDict_GET_SIZE(old_idx) == 0 && old != binding
                        && PyDict_DelItem(tsi, old) < 0)
                    PyErr_Clear();
            } else if (PyErr_Occurred())
                goto err;
            PyObject *resreq = TASK_SLOT(stored, t_resreq_off);
            if (PySet_Contains(ts_allocated_set, old) != 1) {
                f_any = 1;
                f_cpu += RES_DBL(resreq, res_cpu_offset);
                f_mem += RES_DBL(resreq, res_mem_offset);
                if (acc_scalars_strict(
                        &f_sc, RES_OBJ(resreq, res_scalars_offset)) < 0)
                    goto err;
            }
            if (old == ts_pending) {
                p_any = 1;
                p_cpu += RES_DBL(resreq, res_cpu_offset);
                p_mem += RES_DBL(resreq, res_mem_offset);
                if (acc_scalars_strict(
                        &p_sc, RES_OBJ(resreq, res_scalars_offset)) < 0)
                    goto err;
            }
            slot_store(stored, status_offset, binding);
            if (PyDict_SetItem(jtasks, uid, stored) < 0
                    || PyDict_SetItem(new_idx, uid, stored) < 0)
                goto err;
        }
        int rc = 0;
        if (f_any)
            rc |= apply_res_delta(alloc, f_cpu, f_mem, f_sc, +1, 1);
        if (p_any && rc == 0)
            /* Resource.sub is sub_unchecked's: no scalar moves on a
             * pending_request without scalars */
            rc |= apply_res_delta(pend, p_cpu, p_mem, p_sc, -1, 0);
        Py_XDECREF(f_sc);
        Py_XDECREF(p_sc);
        if (rc != 0)
            goto err;
    }

    /* ---- mutation: one accounting pass per node + burst results ---- */
    npos = 0;
    while (PyDict_Next(by_node, &npos, &host, &nitems)) {
        if (PySet_Add(dirty_nodes, host) < 0)
            goto err;
        PyObject *node = PyDict_GetItem(nodes, host);
        PyObject *nd = *_PyObject_GetDictPtr(node);
        PyObject *nname = PyDict_GetItem(nd, s_name);
        PyObject *ntasks = PyDict_GetItem(nd, s_tasks);
        PyObject *nodeobj = PyDict_GetItem(nd, s_node);
        PyObject *idle = PyDict_GetItem(nd, s_idle);
        PyObject *used = PyDict_GetItem(nd, s_used);
        Py_ssize_t ni = PyList_GET_SIZE(nitems);
        if (nodeobj != NULL && nodeobj != Py_None) {
            double t_cpu = 0.0, t_mem = 0.0;
            PyObject *t_sc = NULL;
            for (Py_ssize_t i = 0; i < ni; i++) {
                PyObject *resreq = TASK_SLOT(PyTuple_GET_ITEM(
                    PyList_GET_ITEM(nitems, i), 2), t_resreq_off);
                t_cpu += RES_DBL(resreq, res_cpu_offset);
                t_mem += RES_DBL(resreq, res_mem_offset);
                if (acc_scalars_strict(
                        &t_sc, RES_OBJ(resreq, res_scalars_offset)) < 0)
                    goto err;
            }
            int rc = apply_res_delta(idle, t_cpu, t_mem, t_sc, -1, 0);
            if (rc == 0)
                rc = apply_res_delta(used, t_cpu, t_mem, t_sc, +1, 1);
            Py_XDECREF(t_sc);
            if (rc != 0)
                goto err;
        }
        PyObject *last_burst = NULL, *accepted = NULL, *bound = NULL;
        for (Py_ssize_t i = 0; i < ni; i++) {
            PyObject *nitem = PyList_GET_ITEM(nitems, i);
            PyObject *burst = PyTuple_GET_ITEM(nitem, 0);
            PyObject *ti = PyTuple_GET_ITEM(nitem, 1);
            PyObject *stored = PyTuple_GET_ITEM(nitem, 2);
            PyObject *key = TASK_SLOT(stored, t_key_off);
            if (key == NULL) {
                PyErr_SetString(PyExc_TypeError, "task lacks key_cache");
                goto err;
            }
            Py_INCREF(key);
            PyObject *clone = clone_one(stored);
            if (clone == NULL) {
                Py_DECREF(key);
                goto err;
            }
            slot_store(stored, t_node_name_off, nname);
            slot_store(clone, t_node_name_off, nname);
            int rc = PyDict_SetItem(ntasks, key, clone);
            Py_DECREF(clone);
            Py_DECREF(key);
            if (rc < 0)
                goto err;
            if (burst != last_burst) {
                Py_XDECREF(accepted);
                Py_XDECREF(bound);
                accepted = PyObject_GetAttr(burst, s_accepted);
                bound = PyObject_GetAttr(burst, s_bound);
                last_burst = burst;
                if (accepted == NULL || bound == NULL) {
                    Py_XDECREF(accepted);
                    Py_XDECREF(bound);
                    goto err;
                }
            }
            PyObject *bt = PyTuple_Pack(3, stored,
                                        TASK_SLOT(stored, t_pod_off), host);
            if (bt == NULL || PyList_Append(accepted, ti) < 0
                    || PyList_Append(bound, bt) < 0) {
                Py_XDECREF(bt);
                Py_XDECREF(accepted);
                Py_XDECREF(bound);
                goto err;
            }
            Py_DECREF(bt);
        }
        Py_XDECREF(accepted);
        Py_XDECREF(bound);
    }
    Py_DECREF(by_job);
    Py_DECREF(by_node);
    Py_RETURN_TRUE;

hand_back:
    Py_XDECREF(by_job);
    Py_XDECREF(by_node);
    Py_RETURN_FALSE;
err:
    Py_XDECREF(by_job);
    Py_XDECREF(by_node);
    return NULL;
}
/* attr_eq_filter_pairs(pairs, attr0, attr1, expected)
 *     -> (delivery, flips)
 *
 * Watch-filter evaluation for one bulk delivery when the watcher
 * declared its filter as an attribute equality
 * (Watch.filter_attr — obj.<attr0>.<attr1> == expected): pass->pass
 * pairs collect into the delivery list; filter FLIPS come back as
 * ordered (is_add, obj) events — fail->pass yields (True, new),
 * pass->fail (False, old) — in pair order, so the caller fires
 * on_add/on_delete exactly as the per-pair Python loop would.
 * fail->fail drops. Two Python filter calls per pod otherwise. */
static PyObject *
attr_eq_filter_pairs(PyObject *self, PyObject *args)
{
    PyObject *pairs, *attr0, *attr1, *expected;
    if (!PyArg_ParseTuple(args, "O!UUO", &PyList_Type, &pairs,
                          &attr0, &attr1, &expected))
        return NULL;
    PyObject *delivery = PyList_New(0);
    PyObject *flips = PyList_New(0);
    if (delivery == NULL || flips == NULL)
        goto fail;
    Py_ssize_t n = PyList_GET_SIZE(pairs);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pair = PyList_GET_ITEM(pairs, i);
        if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2) {
            PyErr_SetString(PyExc_TypeError, "pairs items must be 2-tuples");
            goto fail;
        }
        PyObject *old = PyTuple_GET_ITEM(pair, 0);
        PyObject *new = PyTuple_GET_ITEM(pair, 1);
        int flags[2];
        PyObject *objs[2] = {old, new};
        for (int k = 0; k < 2; k++) {
            PyObject **dp = _PyObject_GetDictPtr(objs[k]);
            PyObject *sub = (dp == NULL || *dp == NULL) ? NULL
                : PyDict_GetItemWithError(*dp, attr0);
            PyObject *val = sub == NULL ? NULL : dict_attr(sub, attr1);
            if (PyErr_Occurred())
                goto fail;
            if (val == NULL || (!PyUnicode_Check(val)
                                && val != Py_None)) {
                /* a shape the filter's equality does not cover */
                PyErr_SetString(PyExc_TypeError, "unfilterable shape");
                goto fail;
            }
            flags[k] = str_eq(val, expected);
        }
        if (flags[0] && flags[1]) {
            if (PyList_Append(delivery, pair) < 0)
                goto fail;
        } else if (flags[0] != flags[1]) {
            PyObject *ev = PyTuple_Pack(
                2, flags[1] ? Py_True : Py_False, flags[1] ? new : old);
            if (ev == NULL || PyList_Append(flips, ev) < 0) {
                Py_XDECREF(ev);
                goto fail;
            }
            Py_DECREF(ev);
        }
    }
    return Py_BuildValue("(NN)", delivery, flips);
fail:
    Py_XDECREF(delivery);
    Py_XDECREF(flips);
    return NULL;
}

/* bind_request_items(items) -> list | None
 *
 * The request of bind_pods_batch's store commit in one pass: items is
 * [(pod, hostname)], the result [(pod.metadata.name,
 * pod.metadata.namespace, hostname)]. None, with nothing built, when a
 * pod lacks that shape: a designed hand-back, the caller's list
 * comprehension then runs (and raises as it would). */
static PyObject *
bind_request_items(PyObject *self, PyObject *arg)
{
    if (!PyList_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected a list");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(arg);
    PyObject *reqs = PyList_New(n);
    if (reqs == NULL)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = PyList_GET_ITEM(arg, i);
        PyObject *meta = NULL, *name = NULL, *ns = NULL;
        if (PyTuple_Check(it) && PyTuple_GET_SIZE(it) == 2) {
            meta = dict_attr(PyTuple_GET_ITEM(it, 0), s_metadata);
            name = meta == NULL ? NULL : dict_attr(meta, s_name);
            ns = meta == NULL ? NULL : dict_attr(meta, s_namespace_str);
        }
        if (name == NULL || ns == NULL) {
            Py_DECREF(reqs);
            if (PyErr_Occurred())
                return NULL;
            Py_RETURN_NONE;
        }
        PyObject *req = PyTuple_Pack(3, name, ns, PyTuple_GET_ITEM(it, 1));
        if (req == NULL) {
            Py_DECREF(reqs);
            return NULL;
        }
        PyList_SET_ITEM(reqs, i, req);
    }
    return reqs;
}

static PyMethodDef methods[] = {
    {"register_task_type", register_task_type, METH_O,
     "Register the TaskInfo class (reads its slot offsets)."},
    {"register_task_status", register_task_status, METH_VARARGS,
     "Register the TaskStatus members and the allocated-status set."},
    {"clone_task", clone_task, METH_O, "TaskInfo.clone: a slot copy."},
    {"clone_task_table", clone_task_table, METH_O,
     "A job's task table cloned, with its status index."},
    {"clone_task_dict", clone_task_dict, METH_O,
     "A node's task table cloned (no index)."},
    {"register_resource_type", register_resource_type, METH_O,
     "Register the Resource class (reads its slot offsets)."},
    {"clone_resource", clone_resource, METH_O,
     "Resource.clone: a slot copy with a fresh scalars dict."},
    {"register_pod_types", register_pod_types, METH_VARARGS,
     "Register the Pod, ObjectMeta and PodSpec classes."},
    {"bind_clone_pods", bind_clone_pods, METH_VARARGS,
     "One bind_pods shard: bind clones with node_name and rv set."},
    {"publish_shard", publish_shard, METH_VARARGS,
     "One shard's ordered publish: install, key release, journal "
     "entries and delivery pairs."},
    {"bind_echo_apply", bind_echo_apply, METH_VARARGS,
     "update_pods_bulk's own-write echo over a delivery, up to the "
     "first pair it hands back."},
    {"register_ledger_types", register_ledger_types, METH_VARARGS,
     "Register the ledger's _Entry and _Agg types and its hop table."},
    {"ledger_confirm_runs", ledger_confirm_runs, METH_VARARGS,
     "The ledger's bind-echo completion of a delivery's runs."},
    {"bind_apply_bursts", bind_apply_bursts, METH_VARARGS,
     "The cross-gang bind apply: per-job status moves and one "
     "accounting pass a node, or False with nothing changed."},
    {"attr_eq_filter_pairs", attr_eq_filter_pairs, METH_VARARGS,
     "A bulk delivery classified by an attribute-equality filter."},
    {"bind_request_items", bind_request_items, METH_O,
     "bind_pods_batch's request: [(pod, host)] -> [(name, ns, host)]."},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "volcano_tpu_torch_fastmodel",
    "The native engine of volcano_tpu_torch's snapshot clones and bind "
    "commit path.", -1, methods
};

static PyObject **const interned[] = {
    &s_metadata, &s_spec, &s_node_name, &s_resource_version, &s_modified,
    &s_uid, &s_deletion_timestamp, &s_phase, &s_status,
    &s_task_status_index, &s_tasks, &s_queue, &s_status_version,
    &ph_running, &ph_pending, &ph_succeeded, &ph_failed, &s_pairs,
    &s_accepted, &s_bound, &s_idle, &s_used, &s_name, &s_node,
    &s_gpu_devices, &s_allocated, &s_pending_request, &s_namespace_str,
    &s_append, &s_hop, &s_queue_label, &s_rr, &s_group_sig,
};
static const char *const interned_text[] = {
    "metadata", "spec", "node_name", "resource_version", "MODIFIED",
    "uid", "deletion_timestamp", "phase", "status",
    "task_status_index", "tasks", "queue", "_status_version",
    "Running", "Pending", "Succeeded", "Failed", "pairs",
    "accepted", "bound", "idle", "used", "name", "node",
    "gpu_devices", "allocated", "pending_request", "namespace",
    "append", "hop", "queue", "_rr", "_sched_group_sig",
};

PyMODINIT_FUNC
PyInit_volcano_tpu_torch_fastmodel(void)
{
    size_t n = sizeof(interned) / sizeof(interned[0]);
    if (n != sizeof(interned_text) / sizeof(interned_text[0])) {
        PyErr_SetString(PyExc_SystemError, "interned table mismatch");
        return NULL;
    }
    for (size_t i = 0; i < n; i++)
        if ((*interned[i] = PyUnicode_InternFromString(interned_text[i]))
                == NULL)
            return NULL;
    return PyModule_Create(&moduledef);
}
