"""Google-Sheets-compatible experiment-tracking surface (a copy of
``l3embedding_tpu/utils/gsheets.py``, which holds no JAX).

The reference tracks experiments in a shared Google Sheet through
gsheets.py (get_credentials / append_row / update_experiment / get_row;
reference gsheets.py:81-190). This module keeps that exact function
surface so callers port unchanged, but the backend is pluggable:

  * When `service` is a `LocalSheet` (the default obtained from
    `get_credentials`/`build_service` without Google credentials), rows
    live in a local JSON file — same schema, same upsert-by-model_dir
    semantics, no network.
  * When googleapiclient is importable and real credentials are passed,
    the same calls can be routed to the Sheets API by swapping the
    service object (kept out of the default path: this image has no
    egress).

Column schemas mirror reference gsheets.py:11-73.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .tracker import CLASSIFIER_FIELD_NAMES, EMBEDDING_FIELD_NAMES  # noqa: F401

_SHEET_FIELDS = {
    "embedding": EMBEDDING_FIELD_NAMES,
    "classifier": CLASSIFIER_FIELD_NAMES,
}


class LocalSheet:
    """File-backed 'spreadsheet': one worksheet per name, rows are lists
    aligned to the schema columns."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def _read(self) -> dict:
        if os.path.exists(self.path):
            with open(self.path) as f:
                return json.load(f)
        return {}

    def _write(self, data: dict) -> None:
        tmp = self.path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2, default=str)
        os.replace(tmp, self.path)

    def get_rows(self, sheet_name: str) -> list:
        return self._read().get(sheet_name, [])

    def append(self, sheet_name: str, row: list) -> None:
        with self._lock:
            data = self._read()
            data.setdefault(sheet_name, []).append(row)
            self._write(data)

    def update_cells(self, sheet_name: str, row_idx: int, start_col: int,
                     values: list) -> None:
        with self._lock:
            data = self._read()
            rows = data.setdefault(sheet_name, [])
            while len(rows) <= row_idx:
                rows.append([])
            row = rows[row_idx]
            end = start_col + len(values)
            while len(row) < end:
                row.append("")
            row[start_col:end] = values
            self._write(data)


class GoogleSheet:
    """Real Sheets-API backend exposing the same worksheet trio as
    LocalSheet (get_rows / append / update_cells), so every caller above
    it is backend-agnostic. Requires googleapiclient + credentials
    (reference gsheets.py:112-190 request shapes)."""

    def __init__(self, service, spreadsheet_id: str):
        self._svc = service
        self._id = spreadsheet_id

    def get_rows(self, sheet_name: str) -> list:
        resp = (
            self._svc.spreadsheets()
            .values()
            .get(spreadsheetId=self._id, range=f"{sheet_name}!A:AZ")
            .execute()
        )
        return resp.get("values", [])

    def append(self, sheet_name: str, row: list) -> None:
        (
            self._svc.spreadsheets()
            .values()
            .append(
                spreadsheetId=self._id,
                range=f"{sheet_name}!A1:A1",
                valueInputOption="USER_ENTERED",
                insertDataOption="INSERT_ROWS",
                body={"values": [row]},
            )
            .execute()
        )

    def update_cells(self, sheet_name: str, row_idx: int, start_col: int,
                     values: list) -> None:
        start = _col_idx_to_letter(start_col)
        end = _col_idx_to_letter(start_col + len(values) - 1)
        rng = f"{sheet_name}!{start}{row_idx + 1}:{end}{row_idx + 1}"
        (
            self._svc.spreadsheets()
            .values()
            .update(
                spreadsheetId=self._id,
                range=rng,
                valueInputOption="USER_ENTERED",
                body={"values": [values]},
            )
            .execute()
        )


SHEETS_SCOPES = ["https://www.googleapis.com/auth/spreadsheets"]


def _load_google_credentials(cred_file, required_kind=None):
    """Build google-auth credentials from a JSON key file of either
    kind, dispatching on its "type" field:

      * "service_account" — a robot key (the modern deployment path).
      * "authorized_user" — a stored USER OAuth2 token
        (client_id/client_secret/refresh_token), the direct equivalent
        of the token files the reference's oauth2client flow stored
        under ~/.credentials/ (reference gsheets.py:81-109); google-auth
        refreshes it transparently on first request.

    Returns None (never raises) when the file is unreadable or of an
    unknown type — tracking must never take down a training run."""
    try:
        with open(cred_file) as f:
            kind = json.load(f).get("type")
        if required_kind is not None and kind != required_kind:
            return None
        if kind == "service_account":
            from google.oauth2 import service_account

            return service_account.Credentials.from_service_account_file(
                cred_file, scopes=SHEETS_SCOPES
            )
        if kind == "authorized_user":
            from google.oauth2.credentials import Credentials

            return Credentials.from_authorized_user_file(
                cred_file, scopes=SHEETS_SCOPES
            )
    except Exception:
        pass
    return None


def _user_token_path(google_dev_app_name):
    """Reference storage convention: ~/.credentials/<app_name>.json
    (reference gsheets.py:86-101); overridable via L3_GOOGLE_USER_TOKEN."""
    explicit = os.environ.get("L3_GOOGLE_USER_TOKEN")
    if explicit:
        return explicit
    if not google_dev_app_name:
        return None
    return os.path.join(
        os.path.expanduser("~"), ".credentials", f"{google_dev_app_name}.json"
    )


def get_credentials(google_dev_app_name, spreadsheet_path=None):
    """Returns a credentials token for `build_service`.

    Credential resolution, most explicit first (all optional — without
    any, a no-op marker routes build_service to LocalSheet):

      1. L3_GOOGLE_CREDENTIALS / GOOGLE_APPLICATION_CREDENTIALS — a JSON
         key file, service-account OR stored-user-token kind.
      2. L3_GOOGLE_USER_TOKEN, or the reference's storage convention
         ~/.credentials/<google_dev_app_name>.json — a stored user OAuth2
         token (reference gsheets.py:81-109; mint one once with
         google-auth-oauthlib's InstalledAppFlow on any machine with a
         browser, then copy the token JSON here)."""
    marker = {"app_name": google_dev_app_name, "path": spreadsheet_path}
    # GOOGLE_APPLICATION_CREDENTIALS is often a gcloud ADC user token set
    # globally for OTHER tooling, whose refresh token was never granted
    # the Sheets scope — loading it would fail at request time instead
    # of falling back. Only service-account keys are accepted from it;
    # user tokens must come through the explicit L3_* channels.
    candidates = [
        (os.environ.get("L3_GOOGLE_CREDENTIALS"), None),
        (os.environ.get("GOOGLE_APPLICATION_CREDENTIALS"),
         "service_account"),
        (_user_token_path(google_dev_app_name), None),
    ]
    for cred_file, required_kind in candidates:
        if not cred_file or not os.path.exists(cred_file):
            continue
        creds = _load_google_credentials(cred_file, required_kind)
        if creds is not None:
            marker["google_credentials"] = creds
            break
    return marker


def build_service(credentials, spreadsheet_id):
    """Service factory. Real credentials + googleapiclient → GoogleSheet
    (the reference's live backend, gsheets.py:104-109); otherwise a
    LocalSheet stored next to the experiment data (`spreadsheet_id`
    doubles as the local path when it looks like one)."""
    if credentials.get("google_credentials") is not None:
        try:  # pragma: no cover - needs google libs + network
            from googleapiclient import discovery

            svc = discovery.build(
                "sheets",
                "v4",
                credentials=credentials["google_credentials"],
                cache_discovery=False,
            )
            return GoogleSheet(svc, spreadsheet_id)
        except ImportError:
            pass
    path = credentials.get("path") or (
        spreadsheet_id
        if str(spreadsheet_id).endswith(".json")
        else os.path.join(".", f"sheet_{spreadsheet_id}.json")
    )
    return LocalSheet(path)


def _col_idx_to_letter(idx: int) -> str:
    letters = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        letters = chr(65 + rem) + letters
    return letters


def _col_letter_to_idx(letter: str) -> int:
    idx = 0
    for ch in letter.upper():
        idx = idx * 26 + (ord(ch) - 64)
    return idx - 1


def request_with_retry(request_fn, num_attempts=50, backoff=0.1):
    """Retry wrapper (reference gsheets.py:143-155)."""
    last = None
    for attempt in range(max(1, num_attempts)):
        try:
            return request_fn()
        except Exception as e:  # pragma: no cover - local backend rarely fails
            last = e
            time.sleep(backoff * (attempt + 1))
    raise last


def get_row(service, spreadsheet_id, param_dict, sheet_name):
    """Row index whose model_dir matches, or None
    (reference gsheets.py:158-175). Works on any backend exposing
    get_rows (LocalSheet, GoogleSheet, test doubles)."""
    if not hasattr(service, "get_rows"):
        raise TypeError("unsupported service object")
    fields = _SHEET_FIELDS[sheet_name]
    key_idx = fields.index("model_dir")
    target = str(param_dict.get("model_dir", ""))
    for i, row in enumerate(service.get_rows(sheet_name)):
        if len(row) > key_idx and str(row[key_idx]) == target:
            return i
    return None


def append_row(service, spreadsheet_id, param_dict, sheet_name):
    """Append a schema-ordered row (reference gsheets.py:112-128)."""
    fields = _SHEET_FIELDS[sheet_name]
    row = [str(param_dict.get(f, "")) for f in fields]
    request_with_retry(lambda: service.append(sheet_name, row))


def update_experiment(service, spreadsheet_id, param_dict, start_col,
                      end_col, values, sheet_name):
    """Update the row keyed by model_dir between the given column letters
    (reference gsheets.py:178-190)."""
    row_idx = get_row(service, spreadsheet_id, param_dict, sheet_name)
    if row_idx is None:
        append_row(service, spreadsheet_id, param_dict, sheet_name)
        row_idx = get_row(service, spreadsheet_id, param_dict, sheet_name)
    start = _col_letter_to_idx(start_col)
    request_with_retry(
        lambda: service.update_cells(sheet_name, row_idx, start,
                                     [str(v) for v in values])
    )
